"""The benchmark of micro_aes_tpu_torch (run.py runs one cell)."""
