"""The port's flowlib against the JAX package's, function by function, on
the inputs of tests/test_flowlib_hd3loss.py (TestFlowIO, TestFlowErrors,
TestFlowlibTail). Host numpy, no JAX compile. Files written by both are
equal byte for byte, arrays read back equal exactly, errors within 1e-12.
"""

import numpy as np
import pytest

import dfvo_torch.flowlib as T
import dfvo_tpu.flowlib as J


def test_exports_match_jax():
    names = [n for n in dir(J) if not n.startswith("_") and callable(getattr(J, n))]
    assert names and all(callable(getattr(T, n, None)) for n in names), names
    assert set(T.__all__) >= set(names)


def _same_file(tmp_path, write, data, name):
    """``write(module, data, path)`` through both packages: the bytes."""
    pt, pj = tmp_path / f"t_{name}", tmp_path / f"j_{name}"
    write(T, data, str(pt))
    write(J, data, str(pj))
    assert pt.read_bytes() == pj.read_bytes(), name
    return str(pt)


def test_flo_round_trip(tmp_path):
    flow = np.random.RandomState(0).randn(20, 30, 2).astype(np.float32) * 5
    path = _same_file(tmp_path, lambda m, d, p: m.write_flow(d, p), flow, "f.flo")
    for reader in ("read_flow", "read_flo_file"):
        got, want = getattr(T, reader)(path), getattr(J, reader)(path)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, flow)
    bad = tmp_path / "bad.flo"
    np.array([1.0], np.float32).tofile(str(bad))
    for m in (T, J):
        with pytest.raises(ValueError, match="invalid .flo"):
            m.read_flo_file(str(bad))


@pytest.mark.parametrize("masked", [False, True])
def test_kitti_png_round_trip(tmp_path, masked):
    rng = np.random.RandomState(1)
    flow = rng.randn(20, 30, 2).astype(np.float32) * 10
    flow[0, 0] = [1e4, -1e4]  # clipped to the 16-bit range
    mask = rng.rand(20, 30) > 0.3 if masked else None
    path = _same_file(tmp_path, lambda m, d, p: m.write_kitti_png_flow(d, p, mask), flow,
                      "f.png")
    (gf, gm), (wf, wm) = T.read_kitti_png_flow(path), J.read_kitti_png_flow(path)
    np.testing.assert_array_equal(gf, wf)
    np.testing.assert_array_equal(gm, wm)
    np.testing.assert_array_equal(T.read_flow(path), J.read_flow(path))


def test_pfm_round_trip(tmp_path):
    rng = np.random.RandomState(5)
    for name, data in (("c.pfm", rng.randn(12, 17, 3).astype(np.float32)),
                       ("g.pfm", rng.randn(9, 14).astype(np.float32)),
                       ("g1.pfm", rng.randn(9, 14, 1).astype(np.float32))):
        path = _same_file(tmp_path, lambda m, d, p: m.write_pfm_file(d, p, scale=2.0), data, name)
        got = T.read_pfm_file(path)
        np.testing.assert_array_equal(got, J.read_pfm_file(path))
        np.testing.assert_array_equal(got, data.reshape(got.shape))
    for m in (T, J):
        with pytest.raises(ValueError, match="PFM needs"):
            m.write_pfm_file(np.zeros((3, 4, 2)), str(tmp_path / "x.pfm"))
    (tmp_path / "bad.pfm").write_bytes(b"P6\n1 1\n-1\n")
    for m in (T, J):
        with pytest.raises(ValueError, match="not a PFM"):
            m.read_pfm_file(str(tmp_path / "bad.pfm"))


def test_read_flow_read_disp_and_disp2flow(tmp_path):
    import cv2

    rng = np.random.RandomState(6)
    flow3 = rng.randn(8, 11, 3).astype(np.float32)
    pf = _same_file(tmp_path, lambda m, d, p: m.write_pfm_file(d, p), flow3, "f.pfm")
    np.testing.assert_array_equal(T.read_flow(pf), J.read_flow(pf))
    d = np.abs(rng.randn(8, 11).astype(np.float32))
    pd = _same_file(tmp_path, lambda m, d, p: m.write_pfm_file(d, p), d, "d.pfm")
    disp = T.read_disp(pd)
    np.testing.assert_array_equal(disp, J.read_disp(pd))
    png = tmp_path / "d.png"
    cv2.imwrite(str(png), (rng.rand(8, 11) * 30000 * (rng.rand(8, 11) > 0.2)).astype(np.uint16))
    np.testing.assert_array_equal(T.read_disp(str(png)), J.read_disp(str(png)))
    for dd in (disp, np.concatenate([disp, np.ones_like(disp)], axis=-1), T.read_disp(str(png))):
        np.testing.assert_array_equal(T.disp2flow(dd), J.disp2flow(dd))
    for m in (T, J):
        with pytest.raises(ValueError, match="invalid"):
            m.read_flow(str(tmp_path / "x.txt"))
        with pytest.raises(ValueError, match="invalid"):
            m.read_disp(str(tmp_path / "x.txt"))


def test_flow_to_image():
    rng = np.random.RandomState(2)
    for flow in (rng.randn(16, 16, 2) * 3, np.zeros((2, 2, 2)),
                 np.array([[[5.0, 0], [2e7, 0]], [[np.nan, 1], [-5, 0]]])):
        np.testing.assert_array_equal(T.flow_to_image(flow), J.flow_to_image(flow))


def test_epe_and_fl():
    rng = np.random.RandomState(3)
    tu, tv = rng.randn(50, 60) * 10, rng.randn(50, 60) * 10
    mask = rng.rand(50, 60) > 0.4
    for u, v in ((tu, tv), (tu + 1.0, tv), (tu + 100, tv + 100), (tu + rng.randn(50, 60), tv)):
        for m in (None, mask):
            assert abs(T.flow_error(tu, tv, u, v, m) - J.flow_error(tu, tv, u, v, m)) <= 1e-12
            assert abs(T.flow_kitti_error(tu, tv, u, v, m)
                       - J.flow_kitti_error(tu, tv, u, v, m)) <= 1e-12


def test_evaluate_flow_and_kitti_flow(tmp_path):
    rng = np.random.RandomState(7)
    gt = rng.randn(20, 30, 2) * 5
    gt[3, 4] = 0.0
    gt[5, 6, 0] = 2e7
    pred = gt + 1.0
    assert abs(T.evaluate_flow(gt, pred) - J.evaluate_flow(gt, pred)) <= 1e-12
    gt3 = np.concatenate([gt, (rng.rand(20, 30, 1) > 0.4).astype(np.float64)], axis=-1)
    for g, p in ((gt3, pred), (gt[:, :, :2] * 0.01, pred), (gt3, pred + rng.randn(20, 30, 2) * 4)):
        np.testing.assert_allclose(T.evaluate_kitti_flow(g, p), J.evaluate_kitti_flow(g, p),
                                   rtol=0, atol=1e-12)
    g = (rng.randn(10, 12, 2) * 3).astype(np.float32)
    pg = _same_file(tmp_path, lambda m, d, p: m.write_flow(d, p), g, "gt.flo")
    pp = _same_file(tmp_path, lambda m, d, p: m.write_flow(d, p), g + np.float32(0.5), "p.flo")
    assert abs(T.evaluate_flow_file(pg, pp) - J.evaluate_flow_file(pg, pp)) <= 1e-12


def test_mask_error_and_flips():
    rng = np.random.RandomState(9)
    tu, tv = rng.randn(15, 18) * 8, rng.randn(15, 18) * 8
    gt_mask = (rng.rand(15, 18) > 0.3).astype(np.float64)
    pd_mask = (rng.rand(15, 18) > 0.3).astype(np.float64)
    for u in (tu, tu + 50):
        np.testing.assert_allclose(T.flow_kitti_mask_error(tu, tv, gt_mask, u, tv, pd_mask),
                                   J.flow_kitti_mask_error(tu, tv, gt_mask, u, tv, pd_mask),
                                   rtol=0, atol=1e-12)
    np.testing.assert_array_equal(T.flow_kitti_mask_error(tu, tv, gt_mask * 0, tu, tv, pd_mask),
                                  J.flow_kitti_mask_error(tu, tv, gt_mask * 0, tu, tv, pd_mask))
    flow = np.stack([tu, tv], axis=-1)
    for fn in ("horizontal_flip_flow", "vertical_flip_flow"):
        np.testing.assert_array_equal(getattr(T, fn)(flow), getattr(J, fn)(flow))


def test_remove_ambiguity_resize_and_image_files(tmp_path):
    import cv2

    rng = np.random.RandomState(10)
    flow = rng.randn(9, 11, 2) * 4
    err = np.abs(rng.randn(9, 11)) * 12
    for thre in (10.0, 5.0):
        (ft, mt), (fj, mj) = (m.remove_ambiguity_flow(flow.copy(), err, threshold_err=thre)
                              for m in (T, J))
        np.testing.assert_array_equal(ft, fj)
        np.testing.assert_array_equal(mt, mj)
        assert mt.dtype == mj.dtype == np.uint8
    f32 = flow.astype(np.float32)
    for hw in ((18, 22), (5, 7)):
        np.testing.assert_array_equal(T.resize_flow(f32.copy(), *hw), J.resize_flow(f32.copy(), *hw))
    _same_file(tmp_path, lambda m, d, p: m.save_flow_image(d, p), flow, "img.png")
    pf = _same_file(tmp_path, lambda m, d, p: m.write_flow(d, p), f32, "f.flo")
    _same_file(tmp_path, lambda m, d, p: m.flowfile_to_imagefile(pf, p), None, "img2.png")
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "t_img2.png")),
                                  cv2.cvtColor(T.flow_to_image(f32), cv2.COLOR_RGB2BGR))
