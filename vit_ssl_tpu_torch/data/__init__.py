"""Data pipeline of the port (mirrors ``vit_ssl_tpu/data``)."""
