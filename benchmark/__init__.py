"""The benchmark of hevc_tpu_torch (see README.md)."""
