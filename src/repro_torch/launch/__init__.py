"""Launcher: roofline terms and parameter counts (``roofline``), the
cells and their per-cell settings (``cells``), the step builders
(``steps``) and the meshes they run on (``mesh``)."""
