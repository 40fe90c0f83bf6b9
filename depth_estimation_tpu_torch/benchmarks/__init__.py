"""benchmarks — the port's peak meter and speed-of-light report.

Counterparts of the JAX package's top-level ``benchmarks/device_peaks.py``,
``probe_vpu_peak.py`` and ``speed_of_light.py``, under the same names:

  device_peaks    the card's measured ceilings (FP32 FMA and expf through
                  kernel P1, ``csrc/vpu_peak.cu``; bf16 and f32 matrix
                  products; the HBM stream; the gather's index rate)
  probe_vpu_peak  P2: the FMA rate at 1, 2, 4 and 8 chains, at full
                  occupancy and at 4 warps an SM
  speed_of_light  each hot kernel's time against its least time at the
                  measured and at the published peaks, and the bound
                  formulas that PERF.md's kernel table uses
"""
