"""Dataset registry, keyed as ``dfvo_tpu/datasets/__init__.py``: the YAML's
``dataset`` names the loader."""

from .dataset import Dataset
from .kitti import KittiOdom, KittiRaw

_ITEM13 = "ROADMAP queue 1 item 13, 'The rest'"


def _not_ported(name):
    def make(cfg):
        raise NotImplementedError(
            f"dataset {cfg.dataset!r} ({name}) is not ported yet ({_ITEM13})"
        )

    return make


datasets = {
    "kitti_odom": KittiOdom,
    "kitti_raw": KittiRaw,
    "tum-1": _not_ported("TUM RGB-D"),
    "tum-2": _not_ported("TUM RGB-D"),
    "tum-3": _not_ported("TUM RGB-D"),
    "adelaide1": _not_ported("Adelaide"),
    "adelaide2": _not_ported("Adelaide"),
    "kinect": _not_ported("Kinect"),
    "robotcar": _not_ported("Oxford RobotCar"),
}

__all__ = ["Dataset", "KittiOdom", "KittiRaw", "datasets"]
