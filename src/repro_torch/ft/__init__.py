"""Fault tolerance of the port: restart supervision, failure injection
(:mod:`repro_torch.ft.supervisor`) and the chaos sweep (:mod:`repro_torch.ft.chaos`)."""
