"""Shipped deployment recipes (:mod:`repro_torch.configs.presets`)."""
