"""The benchmark of segsplat_tpu_torch: see README.md."""
