from repro_torch.checkpoint.ckpt import load_checkpoint, restore_latest, save_checkpoint

__all__ = ["load_checkpoint", "restore_latest", "save_checkpoint"]
