"""Dataset registry, keyed as ``dfvo_tpu/datasets/__init__.py``: the YAML's
``dataset`` names the loader. The loaders other than KITTI's are imported
when a configuration asks for them."""

from .dataset import Dataset
from .kitti import KittiOdom, KittiRaw


def _tum(cfg):
    from .tum import TUM

    return TUM(cfg)


def _adelaide(cfg):
    from .adelaide import Adelaide

    return Adelaide(cfg)


def _kinect(cfg):
    from .kinect import Kinect

    return Kinect(cfg)


def _robotcar(cfg):
    from .oxford_robotcar import OxfordRobotCar

    return OxfordRobotCar(cfg)


datasets = {
    "kitti_odom": KittiOdom,
    "kitti_raw": KittiRaw,
    "tum-1": _tum,
    "tum-2": _tum,
    "tum-3": _tum,
    "adelaide1": _adelaide,
    "adelaide2": _adelaide,
    "kinect": _kinect,
    "robotcar": _robotcar,
}

__all__ = ["Dataset", "KittiOdom", "KittiRaw", "datasets"]
