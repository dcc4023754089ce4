"""Launchers of the port (`python -m repro_torch.launch.<name>`). The port
of `repro/launch/`: `serve` (language-model prefill + decode; novel-view
serving in one process or a fleet of worker processes), with `mesh` and
`steps` beneath it."""
