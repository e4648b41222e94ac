"""Launch: the serve driver (:mod:`repro_torch.launch.serve`)."""
