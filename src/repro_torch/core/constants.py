"""Shared thermal constants of the PyTorch port (its own copy of the
reference package's ``core/constants.py``; the values must stay equal).

``AMBIENT_C`` and the 85 °C 3D-DRAM ceiling are imported from here by the
solver, the stack subsystem and the reports, so a calibration change
cannot de-synchronize them.
"""

AMBIENT_C = 45.0        # HotSpot default ambient [C]

DRAM_LIMIT_C = 85.0     # §4.3: max operating temperature of commercial
#   DRAM.  Also the first JEDEC refresh derating bin: above this the
#   refresh interval halves (see repro_torch.stack.dram.refresh_multiplier).
