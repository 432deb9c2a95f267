"""Sharded renders over a ("rays", "samples", "volume") mesh on
``torch.distributed`` (``mesh.py``, ``render_dist.py``), and a launcher
that starts the ranks on one host (``launch.py``)."""
