"""Launchers of the port (`python -m repro_torch.launch.<name>`). The port
of `repro/launch/`: `serve` (language-model prefill + decode; novel-view
serving in one process or a fleet of worker processes) and `train`
(language-model training under the elastic runner), with `mesh`, `steps`
and `elastic` beneath them."""
