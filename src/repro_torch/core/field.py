"""Unified field representation: one `FieldBackend` API over the dense and
the hybrid-compressed (bitmap/COO, paper Sec. 4.2.2) TensoRF parameter
sets. The port of `repro/core/field.py`.

  sigma(pts)          density at world points (Eq. 2)
  app_features(pts)   appearance features (Eq. 2 + basis)
  sigma_app(...)      both, through the fused kernel when grouped by cube
  color(feats, dirs)  view-dependent color MLP
  encode()            -> CompressedField (hybrid bitmap/COO per the 80% rule)
  decode()            -> DenseField (exact inverse)
  prune(...)          magnitude pruning (tol- or target-sparsity-based)
  to(device)          the same field on another device
  sparsity_report()   per-factor format / sparsity / bytes
  trainable()         {name: float payload} the optimizer owns
  with_trainable(t)   the same structure with new payloads
  l1(), tv()          the training regularisers

`SplitField` is a dense field whose planes and lines are split over
the ranks of a "model" group (`core.distributed.split_field`).
`as_backend` is the one place that inspects a field's concrete type.
`field_state`/`field_from_state` carry a field between this package and
the reference as a json-able spec plus named numpy arrays;
`cfg_mismatches` is the restore-time guard against a field of another
config.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.rtnerf import NeRFConfig
from repro_torch.core import sparse, tensorf
from repro_torch.device import DeviceLike, resolve_device


class FieldBackend:
    """Protocol base. Subclasses hold a `cfg` and implement the field API;
    the color MLP is shared (both backends keep it dense)."""

    cfg: NeRFConfig
    kind: str = "abstract"

    def sigma(self, pts: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def app_features(self, pts: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def sigma_app(self, pts: torch.Tensor, cube_centers=None, cube_id=None):
        """(sigma (N,), app_features (N, app_dim)) in one call. Renderers
        that group points by occupancy cube pass `cube_centers` (C, 3
        world) and `cube_id` (N,) so encoded backends can stream per-cube
        factor windows through the fused kernel."""
        return self.sigma(pts), self.app_features(pts)

    def dispatch_path(self) -> str:
        """Which path `sigma_app` takes: "dense", "fused", "fused_ref" or
        "per-op"."""
        return "dense"

    @property
    def mlp_params(self) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        return self.mlp_params["mlp_w1"].device

    def color(self, feats: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
        return tensorf.eval_color(self.mlp_params, self.cfg, feats, dirs)

    def encode(self, threshold: Optional[float] = None) -> "CompressedField":
        raise NotImplementedError

    def decode(self) -> "DenseField":
        raise NotImplementedError

    def prune(self, sparsity: Optional[float] = None,
              tol: Optional[float] = None) -> "FieldBackend":
        raise NotImplementedError

    def to(self, device: DeviceLike) -> "FieldBackend":
        raise NotImplementedError

    def trainable(self) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def with_trainable(self, t: Dict[str, torch.Tensor]) -> "FieldBackend":
        raise NotImplementedError

    def l1(self) -> torch.Tensor:
        raise NotImplementedError

    def tv(self) -> torch.Tensor:
        raise NotImplementedError

    def factor_bytes(self) -> int:
        raise NotImplementedError

    def dense_factor_bytes(self) -> int:
        raise NotImplementedError

    def compression_ratio(self) -> float:
        return self.dense_factor_bytes() / max(self.factor_bytes(), 1)

    def sparsity_report(self) -> Dict[str, Dict]:
        """{"<key>[<mode>]": {"format", "sparsity", "bytes",
        "dense_bytes"}} per VM factor slice: the reference's dict, equal
        to it under `==`."""
        raise NotImplementedError


@dataclasses.dataclass(eq=False)
class DenseField(FieldBackend):
    """The raw TensoRF parameter dict behind the FieldBackend protocol."""

    params: Dict[str, torch.Tensor]
    cfg: NeRFConfig
    kind = "dense"

    def sigma(self, pts):
        return tensorf.eval_sigma(self.params, self.cfg, pts)

    def app_features(self, pts):
        return tensorf.eval_app_features(self.params, self.cfg, pts)

    @property
    def mlp_params(self):
        return self.params

    def encode(self, threshold: Optional[float] = None) -> "CompressedField":
        """Hybrid-encode every VM factor slice (on the host), with the
        streams placed on this field's device."""
        if threshold is None:
            threshold = self.cfg.sparse_threshold
        dev = self.device
        factors: Dict[str, Tuple[sparse.EncodedFactor, ...]] = {}
        extras = {k: v for k, v in self.params.items()
                  if k not in sparse.FACTOR_KEYS}
        for k in sparse.FACTOR_KEYS:
            w = self.params[k].detach().cpu().numpy()
            efs = []
            for m in range(3):
                wm = w[m].reshape(w.shape[1], -1)
                ef = sparse.encode_factor(wm, threshold, device=dev)
                efs.append(dataclasses.replace(ef, nd_shape=w[m].shape))
            factors[k] = tuple(efs)
        return CompressedField(factors=factors, extras=extras, cfg=self.cfg,
                               threshold=threshold)

    def decode(self) -> "DenseField":
        return self

    def prune(self, sparsity: Optional[float] = None,
              tol: Optional[float] = None) -> "DenseField":
        if sparsity is not None:
            return DenseField(
                tensorf.prune_to_sparsity(self.params, sparsity), self.cfg)
        return DenseField(
            tensorf.prune_factors(self.params,
                                  tol=1e-3 if tol is None else tol),
            self.cfg)

    def to(self, device: DeviceLike) -> "DenseField":
        return DenseField({k: v.to(device) for k, v in self.params.items()},
                          self.cfg)

    def trainable(self):
        return dict(self.params)

    def with_trainable(self, t):
        return DenseField(dict(t), self.cfg)

    def revive(self, grads: Dict[str, torch.Tensor], *, frac: float,
               eps: float) -> "DenseField":
        """Support revival at a re-encode boundary (RigL-style regrowth):
        entries pruned to exact zero get no gradient between encodes, so
        per VM factor the top `frac` (of all entries) zero entries by
        |dense loss gradient| are seeded with a step of magnitude `eps`
        against the gradient; `eps` above the prune tolerance keeps them
        through the next prune. Runs on the host in numpy, as the
        reference does, so that the same gradients pick the same entries.
        The MLP and basis are untouched."""
        if frac <= 0.0:
            return self
        out = dict(self.params)
        for k in sparse.FACTOR_KEYS:
            w = _np(self.params[k])
            g = _np(grads[k])
            zero = w == 0
            score = np.where(zero, np.abs(g), -1.0).reshape(-1)
            k_top = min(int(frac * score.size), int(zero.sum()))
            if k_top <= 0:
                continue
            top = np.argpartition(-score, k_top - 1)[:k_top]
            top = top[score[top] > 0.0]        # never revive grad-free zeros
            seed = np.zeros(score.size, w.dtype)
            seed[top] = -eps * np.sign(g.reshape(-1)[top])
            out[k] = torch.from_numpy(
                (w.reshape(-1) + seed).reshape(w.shape)).to(
                    self.params[k].device)
        return DenseField(out, self.cfg)

    def l1(self):
        return tensorf.field_l1(self.params)

    def tv(self):
        return tensorf.field_tv(self.params)

    def factor_bytes(self) -> int:
        return sum(self.params[k].numel() * 4 for k in sparse.FACTOR_KEYS)

    def dense_factor_bytes(self) -> int:
        return self.factor_bytes()

    def sparsity_report(self):
        out = {}
        for k in sparse.FACTOR_KEYS:
            w = self.params[k].detach().cpu().numpy()
            for m in range(3):
                wm = w[m].reshape(w.shape[1], -1)
                b = sparse.storage_bytes(wm.shape, int((wm != 0).sum()),
                                         "dense")
                out[f"{k}[{m}]"] = {"format": "dense",
                                    "sparsity": sparse.sparsity(wm),
                                    "bytes": b, "dense_bytes": b}
        return out


@dataclasses.dataclass(eq=False)
class CompressedField(FieldBackend):
    """The full TensoRF parameter set with every VM factor hybrid-encoded.

    `factors[key][m]` is the sparse.EncodedFactor for mode m of factor
    tensor `key`; `extras` carries the dense basis and color MLP."""

    factors: Dict[str, Tuple[sparse.EncodedFactor, ...]]
    extras: Dict[str, torch.Tensor]
    cfg: NeRFConfig
    threshold: float = 0.80
    kind = "compressed"

    def sigma(self, pts):
        return tensorf.eval_sigma_hybrid(self, self.cfg, pts)

    def app_features(self, pts):
        return tensorf.eval_app_features_hybrid(self, self.cfg, pts)

    def sigma_app(self, pts, cube_centers=None, cube_id=None):
        """Fused streaming eval when the caller supplies cube grouping;
        without it, the per-point gather composition."""
        if cube_centers is None or cube_id is None:
            return self.sigma(pts), self.app_features(pts)
        base = tensorf.window_base(self.cfg, cube_centers)
        return tensorf.eval_sigma_app_hybrid(self, self.cfg, pts, base,
                                             cube_id)

    def dispatch_path(self) -> str:
        return tensorf.hybrid_dispatch(self)

    @property
    def mlp_params(self):
        return self.extras

    def encode(self, threshold: Optional[float] = None) -> "CompressedField":
        if threshold is None or threshold == self.threshold:
            return self
        return self.decode().encode(threshold)

    def decode(self) -> DenseField:
        """Exact inverse of DenseField.encode."""
        params = dict(self.extras)
        for k, efs in self.factors.items():
            params[k] = torch.stack([ef.decode().reshape(ef.nd_shape)
                                     for ef in efs])
        return DenseField(params, self.cfg)

    def prune(self, sparsity: Optional[float] = None,
              tol: Optional[float] = None) -> "CompressedField":
        """Prune re-chooses the support: round-trip through the dense form
        and re-encode."""
        return self.decode().prune(sparsity, tol).encode(self.threshold)

    def to(self, device: DeviceLike) -> "CompressedField":
        return CompressedField(
            {k: tuple(ef.to(device) for ef in efs)
             for k, efs in self.factors.items()},
            {k: v.to(device) for k, v in self.extras.items()},
            self.cfg, self.threshold)

    def trainable(self):
        """Float payloads only: `extras/<k>` and the packed values of each
        factor slice, `factors/<k>/<m>`. The codec's integer streams are
        not trainable: gradients land on the values through the gathers'
        backward, and the support stays fixed until the next re-encode."""
        out = {f"extras/{k}": v for k, v in self.extras.items()}
        for k, efs in self.factors.items():
            for m, ef in enumerate(efs):
                out[f"factors/{k}/{m}"] = ef.value_array
        return out

    def with_trainable(self, t):
        extras = {k: t[f"extras/{k}"] for k in self.extras}
        factors = {k: tuple(ef.with_value_array(t[f"factors/{k}/{m}"])
                            for m, ef in enumerate(efs))
                   for k, efs in self.factors.items()}
        return CompressedField(factors, extras, self.cfg, self.threshold)

    def l1(self):
        """tensorf.field_l1 of the decoded field: the packed values hold
        every non-zero, and zeros add nothing to a mean of |w|."""
        tot = 0.0
        for efs in self.factors.values():
            num = sum(tensorf.abs_grad1(ef.value_array).sum()
                      for ef in efs)
            den = sum(int(np.prod(ef.shape)) for ef in efs)
            tot = tot + num / den
        return tot

    def tv(self):
        """TV needs each plane's neighbourhood, so it decodes the planes,
        differentiably in their values (loss only: renders never
        materialise the grids)."""
        def planes(key):
            return torch.stack([ef.decode().reshape(ef.nd_shape)
                                for ef in self.factors[key]])
        return tensorf.field_tv({"sigma_planes": planes("sigma_planes"),
                                 "app_planes": planes("app_planes")})

    def factor_bytes(self) -> int:
        return sum(ef.storage() for efs in self.factors.values()
                   for ef in efs)

    def dense_factor_bytes(self) -> int:
        return sum(ef.dense_storage() for efs in self.factors.values()
                   for ef in efs)

    def sparsity_report(self):
        return {f"{k}[{m}]": {"format": ef.fmt, "sparsity": ef.sparsity,
                              "bytes": ef.storage(),
                              "dense_bytes": ef.dense_storage()}
                for k, efs in self.factors.items()
                for m, ef in enumerate(efs)}

    def formats(self) -> Dict[str, Tuple[str, ...]]:
        """Per factor key, the format of each mode slice."""
        return {k: tuple(ef.fmt for ef in efs)
                for k, efs in self.factors.items()}


@dataclasses.dataclass(eq=False)
class SplitField(FieldBackend):
    """A dense field split over the ranks of a "model" group
    (`core.distributed.split_field`): `params` are this rank's local
    tensors, its channels lo:hi of each split head's planes and lines
    (`channels`: "sigma" / "app" -> (lo, hi); a head not named is whole),
    the rest whole. Eq. 2 runs on the local channels and `reduce` sums
    the partials over the group: the density's sum before its softplus,
    the (N, app_dim) features after the local channels' basis rows.
    `share` passes the whole basis to the rows a rank uses (its backward
    sums the rows' gradients over the group). L1 and TV sum each split
    leaf's shard over the whole leaf's count (`numel`) and reduce once;
    a whole head is evaluated whole on every rank and counted once. The
    MLP runs on the reduced features, the same on every rank. Encoding,
    pruning and moving a split field are not defined: make its params
    whole first (`core.distributed.whole_nerf_params`)."""

    params: Dict[str, torch.Tensor]
    cfg: NeRFConfig
    channels: Dict[str, Tuple[int, int]]
    numel: Dict[str, int]
    reduce: Callable[[torch.Tensor], torch.Tensor]
    share: Callable[[torch.Tensor], torch.Tensor]
    kind = "split"

    def sigma(self, pts):
        raw = tensorf.sigma_sum(self.params["sigma_planes"],
                                self.params["sigma_lines"], self.cfg, pts)
        if "sigma" in self.channels:
            raw = self.reduce(raw)
        return torch.nn.functional.softplus(raw)

    def app_features(self, pts):
        if "app" not in self.channels:
            return tensorf.eval_app_features(self.params, self.cfg, pts)
        lo, hi = self.channels["app"]
        basis = tensorf.basis_rows(self.share(self.params["basis"]),
                                   self.cfg.r_color, lo, hi)
        return self.reduce(tensorf.app_sum(
            self.params["app_planes"], self.params["app_lines"], basis,
            self.cfg, pts))

    @property
    def mlp_params(self):
        return self.params

    def trainable(self):
        return dict(self.params)

    def with_trainable(self, t):
        return dataclasses.replace(self, params=dict(t))

    def _is_split(self, key: str) -> bool:
        return key.split("_")[0] in self.channels

    def _regulariser(self, term, keys) -> torch.Tensor:
        """The sum of `term(leaf, count)` over `keys`: the split leaves'
        shares reduced over the group, the whole leaves' added after."""
        part = [term(self.params[k], self.numel[k]) for k in keys
                if self._is_split(k)]
        out = self.reduce(torch.stack(part).sum()) if part else 0.0
        for k in keys:
            if not self._is_split(k):
                out = out + term(self.params[k], None)
        return out

    def l1(self):
        return self._regulariser(tensorf.factor_l1, sparse.FACTOR_KEYS)

    def tv(self):
        return self._regulariser(tensorf.plane_tv,
                                 ("sigma_planes", "app_planes"))


def as_backend(field, cfg: Optional[NeRFConfig] = None) -> FieldBackend:
    """Coerce a params dict (cfg required) or a backend into a backend."""
    if isinstance(field, FieldBackend):
        return field
    if isinstance(field, dict):
        if cfg is None:
            raise ValueError("as_backend(dict) needs the NeRFConfig")
        return DenseField(dict(field), cfg)
    raise TypeError(f"not a field: {type(field).__name__} (expected a "
                    f"FieldBackend or a TensoRF params dict)")


# --------------------------------------------------------------------------
# Serialization: the reference's `field_state` format, both ways
# --------------------------------------------------------------------------


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def field_state(field: FieldBackend):
    """(json-able spec, {name: numpy array}) in the reference's format:
    bitmap words as uint32, rank tables omitted."""
    if isinstance(field, DenseField):
        return ({"kind": "dense"},
                {f"params/{k}": _np(v) for k, v in field.params.items()})
    spec = {"kind": "compressed", "threshold": field.threshold,
            "factors": {}}
    arrays = {f"extras/{k}": _np(v) for k, v in field.extras.items()}
    for k, efs in field.factors.items():
        spec["factors"][k] = []
        for m, ef in enumerate(efs):
            spec["factors"][k].append({
                "fmt": ef.fmt, "nd_shape": list(ef.nd_shape),
                "shape": list(ef.shape), "nnz": ef.nnz,
                "sparsity": ef.sparsity})
            base = f"factors/{k}/{m}"
            if ef.fmt == "dense":
                arrays[f"{base}/dense"] = _np(ef.dense)
            elif ef.fmt == "bitmap":
                arrays[f"{base}/words"] = _np(ef.bitmap.words).view(np.uint32)
                arrays[f"{base}/rowptr"] = _np(ef.bitmap.rowptr)
                arrays[f"{base}/values"] = _np(ef.bitmap.values)
            else:
                arrays[f"{base}/coords"] = _np(ef.coo.coords)
                arrays[f"{base}/values"] = _np(ef.coo.values)
    return spec, arrays


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def field_from_state(spec: Dict, arrays: Dict, cfg: NeRFConfig, *,
                     device: DeviceLike = None) -> FieldBackend:
    """Inverse of `field_state` (the reference's or this package's): the
    same dense or encoded field on `device`, with the bitmap rank tables
    recomputed (they are never serialized)."""
    dev = resolve_device(device)
    A = {k: _tensor(v, dev) for k, v in arrays.items()}
    if spec["kind"] == "dense":
        return DenseField({k[len("params/"):]: v for k, v in A.items()
                           if k.startswith("params/")}, cfg)
    extras = {k[len("extras/"):]: v for k, v in A.items()
              if k.startswith("extras/")}
    factors: Dict[str, Tuple[sparse.EncodedFactor, ...]] = {}
    for k, metas in spec["factors"].items():
        efs = []
        for m, meta in enumerate(metas):
            base = f"factors/{k}/{m}"
            shape = tuple(meta["shape"])
            ef = sparse.EncodedFactor(
                fmt=meta["fmt"], nd_shape=tuple(meta["nd_shape"]),
                shape=shape, nnz=int(meta["nnz"]),
                sparsity=float(meta["sparsity"]))
            if ef.fmt == "dense":
                ef.dense = A[f"{base}/dense"]
            elif ef.fmt == "bitmap":
                words, rowptr = A[f"{base}/words"], A[f"{base}/rowptr"]
                ef.bitmap = sparse.BitmapEncoded(
                    shape, words, rowptr, A[f"{base}/values"], ef.nnz,
                    rank=sparse.bitmap_rank(words, rowptr))
            else:
                ef.coo = sparse.CooEncoded(shape, A[f"{base}/coords"],
                                           A[f"{base}/values"], ef.nnz)
            efs.append(ef)
        factors[k] = tuple(efs)
    return CompressedField(factors, extras, cfg,
                           float(spec.get("threshold", 0.80)))


def cfg_mismatches(field, cfg: NeRFConfig) -> List[str]:
    """Shape-compare a (possibly encoded) field against the shapes
    `tensorf.init_field(cfg)` would allocate (`tensorf.field_shapes`,
    computed without allocating): the restore-time guard against serving
    a field trained under another NeRFConfig. Returns the reference's
    mismatch descriptions (empty = compatible)."""
    like = tensorf.field_shapes(cfg)
    field = as_backend(field, cfg)
    if isinstance(field, DenseField):
        got = {k: tuple(v.shape) for k, v in field.params.items()}
    else:
        got = {k: tuple(v.shape) for k, v in field.extras.items()}
        for k, efs in field.factors.items():
            got[k] = (len(efs),) + tuple(efs[0].nd_shape)
    bad = []
    for k in sorted(like):          # the reference's order: jax sorts keys
        shape = like[k]
        if k not in got:
            bad.append(f"{k}: missing from field")
        elif tuple(got[k]) != tuple(shape):
            bad.append(f"{k}: field {tuple(got[k])} != cfg {tuple(shape)}")
    return bad
