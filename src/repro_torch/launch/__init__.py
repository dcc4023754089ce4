"""Launchers of the port (`python -m repro_torch.launch.<name>`). The port
of `repro/launch/`: `serve` (novel-view serving, one process or a fleet of
worker processes)."""
