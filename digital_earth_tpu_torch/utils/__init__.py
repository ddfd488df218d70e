"""utils layer of the PyTorch port (mirrors digital_earth_tpu/utils)."""
