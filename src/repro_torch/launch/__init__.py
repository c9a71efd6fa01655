"""Launcher: roofline terms and parameter counts (``roofline``), the
cells and their per-cell settings (``cells``), the step builders
(``steps``) and the meshes they run on (``mesh``), the cost counter and
per-block costs of a step (``costing``), and the dry run of every cell
on the fake 256- and 512-rank groups (``dryrun``)."""
