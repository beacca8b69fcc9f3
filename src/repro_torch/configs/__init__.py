"""Architecture configs (``<arch>.py``: ``CONFIG`` at the published widths,
``SMOKE`` reduced for the CPU; :mod:`repro_torch.configs.base`) and shipped
deployment recipes (:mod:`repro_torch.configs.presets`)."""
