"""Utilities of the port (mirrors ``vit_ssl_tpu/utils``)."""
