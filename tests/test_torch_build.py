"""The kernel build (`repro_torch.kernels._build.build`) from two processes
that start cold at once: one whole library lands in `build/<hash>/`, no
object of one build is mixed with another's, and no temporary directory
is left behind. A fake `nvcc` stands in for the toolkit: it writes each
object slowly, line by line and tagged with its process id, and links by
concatenating the objects, so a library built from interleaved writes
shows up as an object with two writers' ids or a broken line count."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.kernels import _build

REPO = Path(__file__).resolve().parent.parent

FAKE_NVCC = textwrap.dedent('''\
    #!{python}
    import os, sys, time
    args = sys.argv[1:]
    out = args[args.index("-o") + 1]
    if "-shared" in args:
        objs = args[args.index("-o") + 2:]
        with open(out, "w") as f:
            for o in objs:
                f.write(open(o).read())
        sys.exit(0)
    src = args[args.index("-c") + 1]
    with open(out, "w") as f:
        for i in range(8):
            f.write(f"{{os.path.basename(src)}} {{os.getpid()}} {{i}}\\n")
            f.flush()
            time.sleep(0.02)
    print("ptxas info    : Used 1 registers")
''')

BUILD = textwrap.dedent('''\
    import sys
    from pathlib import Path
    from repro_torch.kernels import _build
    _build.BUILD_ROOT = Path(sys.argv[1])
    print(_build.build())
''')


def _fake_toolkit(tmp_path: Path) -> Path:
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    return bindir


def test_two_cold_builds_at_once_leave_one_whole_library(tmp_path):
    bindir = _fake_toolkit(tmp_path)
    root = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               CUDA_HOME=str(bindir.parent),
               PATH=f"{bindir}{os.pathsep}{os.environ.get('PATH', '')}")
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, str(root)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    libs = {Path(out.strip()) for out, _ in outs}
    want = root / _build.source_hash() / _build.LIB_NAME
    assert libs == {want}
    # only the finished build directory is left: no temporary directory
    assert sorted(p.name for p in root.iterdir()) == [_build.source_hash()]
    assert sorted(p.name for p in want.parent.iterdir()) == sorted(
        ["build.log", _build.LIB_NAME])
    # one process's objects, each whole, in source order
    lines = want.read_text().splitlines()
    srcs = [p.name for p in sorted(_build.CSRC.glob("*.cu"))]
    assert [ln.split()[0] for ln in lines] == [s for s in srcs
                                               for _ in range(8)]
    assert [int(ln.split()[2]) for ln in lines] == list(range(8)) * len(srcs)
    for i in range(0, len(lines), 8):      # each object from one writer
        assert len({ln.split()[1] for ln in lines[i:i + 8]}) == 1
    assert "Used 1 registers" in (want.parent / "build.log").read_text()


def test_a_failed_build_leaves_no_temporary_directory(tmp_path, monkeypatch):
    bindir = _fake_toolkit(tmp_path)
    (bindir / "nvcc").write_text(f"#!{sys.executable}\nimport sys\n"
                                 "print('error: no')\nsys.exit(1)\n")
    monkeypatch.setenv("CUDA_HOME", str(bindir.parent))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build()
    assert list((tmp_path / "build").iterdir()) == []
