"""Scenes, cameras and ray batches (the port of `repro/data`)."""
