"""Command-line entry points: ``python -m dfvo_torch.apis.run`` (the VO
pipeline), ``python -m dfvo_torch.apis.run_multiseq`` (several sequences),
``python -m dfvo_torch.apis.eval_odom`` (KITTI scoring) and
``python -m dfvo_torch.apis.tum_eval`` (TUM scoring)."""
