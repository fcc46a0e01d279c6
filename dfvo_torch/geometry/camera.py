"""Host-side SE(3) pose and pinhole-camera containers.

Counterpart of ``dfvo_tpu/geometry/camera.py`` (the reference DF-VO's
camera_modules.py): plain numpy, for pose bookkeeping and dataset
intrinsics on the host. Device-side geometry is in ``geometry/ops.py``.
"""

import numpy as np


class SE3:
    """An SE(3) rigid transform stored as a 4x4 homogeneous matrix."""

    def __init__(self, np_arr=None):
        if np_arr is None:
            self._pose = np.eye(4)
        else:
            self._pose = np.array(np_arr, dtype=np.float64).reshape(4, 4).copy()

    @property
    def pose(self):
        """(array, [4x4]): the homogeneous transformation matrix."""
        return self._pose

    @pose.setter
    def pose(self, value):
        self._pose = np.array(value, dtype=np.float64).reshape(4, 4).copy()

    @property
    def inv_pose(self):
        """(array, [4x4]): inverse of the transformation matrix."""
        return np.linalg.inv(self._pose)

    @inv_pose.setter
    def inv_pose(self, value):
        self._pose = np.linalg.inv(np.array(value, dtype=np.float64).reshape(4, 4))

    @property
    def R(self):
        """(array, [3x3]): rotation."""
        return self._pose[:3, :3]

    @R.setter
    def R(self, value):
        self._pose[:3, :3] = np.array(value).reshape(3, 3)

    @property
    def t(self):
        """(array, [3x1]): translation."""
        return self._pose[:3, 3:]

    @t.setter
    def t(self, value):
        self._pose[:3, 3:] = np.array(value).reshape(3, 1)

    def copy(self):
        return SE3(self._pose)

    def __matmul__(self, other):
        if isinstance(other, SE3):
            return SE3(self._pose @ other._pose)
        return self._pose @ other

    def __repr__(self):
        return f"SE3(\n{self._pose}\n)"


class Intrinsics:
    """Pinhole intrinsics; accepts [cx, cy, fx, fy] (reference param order,
    camera_modules.py:64-133)."""

    def __init__(self, param=None):
        if param is None:
            param = [0.0, 0.0, 1.0, 1.0]
        cx, cy, fx, fy = param
        self.cx = float(cx)
        self.cy = float(cy)
        self.fx = float(fx)
        self.fy = float(fy)

    @property
    def mat(self):
        """(array, [3x3]): camera matrix K."""
        return np.array(
            [
                [self.fx, 0.0, self.cx],
                [0.0, self.fy, self.cy],
                [0.0, 0.0, 1.0],
            ]
        )

    @property
    def inv_mat(self):
        """(array, [3x3]): K^-1 (closed form)."""
        return np.array(
            [
                [1.0 / self.fx, 0.0, -self.cx / self.fx],
                [0.0, 1.0 / self.fy, -self.cy / self.fy],
                [0.0, 0.0, 1.0],
            ]
        )

    def scale(self, sy, sx):
        """Return intrinsics rescaled by image-size ratios (sy, sx)."""
        return Intrinsics(
            [self.cx * sx, self.cy * sy, self.fx * sx, self.fy * sy]
        )
