"""Helpers of the port: a zlib-only PNG writer, image and attention grids
with PIL's default-font labels drawn without PIL, and the metrics log."""
