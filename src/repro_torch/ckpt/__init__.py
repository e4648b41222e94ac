"""Checkpointing of the port: the reference's on-disk formats, generic and
prepared (:mod:`repro_torch.ckpt.checkpoint`)."""
