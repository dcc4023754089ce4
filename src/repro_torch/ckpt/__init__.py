from repro_torch.ckpt.checkpoint import (  # noqa: F401
    CheckpointManager, latest_step, latest_steps, read_manifest,
    restore_checkpoint, restore_field, restore_state_dict, save_checkpoint,
    save_field, save_state_dict, spill_field, unspill_field)
