"""Test-support utilities (no runtime dependencies on the main API).

- `chaos_serve`: serving chaos + load harness (dyadic boosters for
  bit-identical device/host answers, closed/open-loop heavy-tailed
  load generation, chaos orchestration hooks), the port's copy of
  lightgbm_tpu/testing/chaos_serve.py.
"""
