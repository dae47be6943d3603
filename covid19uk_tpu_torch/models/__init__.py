"""See the package docstring of covid19uk_tpu_torch."""
