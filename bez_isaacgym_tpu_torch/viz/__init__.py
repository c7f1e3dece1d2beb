"""Visualization: headless episode rendering, a live MJPEG viewer and the
debug reward dashboard (port of `bez_isaacgym_tpu/viz/`).

matplotlib is imported only where a figure is drawn (the card machine has
none): the geometry (`render._skeleton`, `_mesh_polys_world`) runs without
it, and drawing without it raises an ImportError that names it.
"""
