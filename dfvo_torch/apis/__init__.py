"""Command-line entry points: ``python -m dfvo_torch.apis.run`` (the VO
pipeline) and ``python -m dfvo_torch.apis.eval_odom`` (KITTI scoring)."""
