"""The traffic generator: one seed gives the same bytes, cruise flows
reproject the depths by the generated motion, stop frames do not move."""

import numpy as np
import pytest
import torch

from perfbench import oracle

SEED = 2**31 + 7


def small(name, **kw):
    tr = dict(oracle.load_traffic(name), frame_hw=[48, 160], chunks=2, **kw)
    return tr


@pytest.fixture(scope="module")
def stops_drive():
    return small("stops", stop_frames=3), oracle.make_drive(small("stops", stop_frames=3), 8,
                                                             SEED, "cpu")


def test_same_seed_same_bytes(stops_drive):
    tr, d = stops_drive
    again = oracle.make_drive(tr, 8, SEED, "cpu")
    for k in ("frames", "depths", "flows", "flow_diff"):
        assert torch.equal(d[k], again[k]), k
    assert np.array_equal(d["motions"], again["motions"])
    other = oracle.make_drive(tr, 8, SEED + 1, "cpu")
    assert not torch.equal(d["depths"], other["depths"])


def test_shapes_and_stop_plan(stops_drive):
    tr, d = stops_drive
    h, w = tr["frame_hw"]
    assert tuple(d["frames"].shape) == (17, h, w, 3) and d["frames"].dtype == torch.uint8
    assert tuple(d["flows"].shape) == (16, h, w, 2)
    stopped = d["stopped"].reshape(2, 8)
    assert (stopped.sum(axis=1) == 3).all()
    assert not stopped[:, 0].any()  # a chunk never starts stopped


def clean_mask(d, i):
    """Pixels outside the rectangles whose flow was corrupted."""
    return d["flow_diff"][i] < 0.5


@pytest.mark.parametrize("name", ["cruise", "stops"])
def test_flows_reproject_depths(name):
    tr = small(name, stop_frames=3) if name == "stops" else small(name)
    d = oracle.make_drive(tr, 8, SEED, "cpu")
    K = d["K"]
    h, w = tr["frame_hw"]
    ys, xs = np.mgrid[0:h, 0:w]
    rays = np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(K).T
    for i in range(len(d["motions"])):
        T = np.linalg.inv(d["motions"][i])
        pts = rays * d["depths"][i].double().numpy()[..., None] @ np.eye(3)
        pts = pts @ T[:3, :3].T + T[:3, 3]
        uv = pts @ K.T
        flow = uv[..., :2] / uv[..., 2:] - np.stack([xs, ys], -1)
        m = clean_mask(d, i).numpy()
        assert m.mean() > 0.3
        np.testing.assert_allclose(d["flows"][i].numpy()[m], flow[m], atol=2e-3)


def test_stop_frames_have_zero_motion(stops_drive):
    _, d = stops_drive
    for i in np.flatnonzero(d["stopped"]):
        assert np.array_equal(d["motions"][i], np.eye(4))
        m = clean_mask(d, i)
        assert float(d["flows"][i][m].abs().max()) < 1e-6
        # the depth chain stands still too
        torch.testing.assert_close(d["depths"][i + 1], d["depths"][i])
    moving = np.flatnonzero(~d["stopped"])
    assert all(np.linalg.norm(d["motions"][i][:3, 3]) > 0.5 for i in moving)
