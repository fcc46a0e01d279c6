"""VO-state checkpoints and resume, and the step checkpoint logger, on the
CPU (the port's counterparts of tests/test_resume.py and
tests/test_checkpoint.py).

The resumed run is held to the port's own straight run:
tests/test_torch_dfvo.py already holds the straight run to the JAX
package's ``DFVO.main``. Sequence, configuration and weights are that
test's (64x96, 32 hypotheses, float32, the flow heads x10 so the camera
moves far above the tolerance), with 20 PnP hypotheses a repeat (the
seeded weights send every frame to PnP).
"""

import numpy as np
import pytest
import torch

from dfvo_torch.models import convert as bridge
from dfvo_torch.pipeline.dfvo import DFVO
from dfvo_torch.utils import ConfigLoader
from dfvo_torch.utils.checkpoint import CheckpointLogger, restore_variables, save_variables
from dfvo_torch.utils.io import load_poses_from_txt
from tests.test_torch_dfvo import _frame_cfg, tiny_kitti  # noqa: F401 (fixture)
from tests.test_torch_models import _perturb, seeded_flax_variables

# the fields of the JAX package's DFVO.save_state train_state, with their
# dtypes (shapes at 64x96 after frames 0..2)
STATE_FIELDS = {
    "global_poses": (torch.float32, (3, 4, 4)),
    "pose_ids": (torch.int64, (3,)),
    "tracking_stage": (torch.int64, ()),
    "prev_scale": (torch.float32, ()),
    "ref_id": (torch.int64, ()),
    "ref_motion": (torch.float32, (4, 4)),
    "ref_raw_depth": (torch.float32, (64, 96)),
    "ref_img": (torch.uint8, (64, 96, 3)),
}


@pytest.fixture(scope="module")
def weights():
    jvars = seeded_flax_variables(0)
    jvars["flow"] = _perturb(jvars["flow"], np.random.RandomState(0), head_scale=10.0)
    return {"depth": bridge.monodepth2_depth_from_flax(jvars["depth"]),
            "flow": bridge.liteflownet_from_flax(jvars["flow"])}


def _vo(root, result_dir, variables=None, finetune=False):
    cfg = _frame_cfg(ConfigLoader, root, result_dir)
    cfg.pnp_tracker.ransac.iter = 20  # every frame goes to PnP: 5 x 20 hypotheses
    if finetune:
        cfg.online_finetune.enable = True
        cfg.online_finetune.num_frames = 2
        cfg.online_finetune.flow.enable = True
        cfg.online_finetune.flow.scales = [1]
        cfg.online_finetune.depth.enable = False
    vo = DFVO(cfg, device="cpu")
    if variables is not None:
        vo.variables = {net: {k: v.clone() for k, v in sd.items()}
                        for net, sd in variables.items()}
        vo.infer_variables = vo.frontend.prepare_variables(vo.variables)
    return vo


def test_save_and_resume_matches_straight_run(tiny_kitti, weights, tmp_path):  # noqa: F811
    """A straight 6-frame run against 3 frames, ``save_state``, a fresh
    instance (its own seeded weights until ``load_state``), ``load_state``
    and ``main(start_frame=ref_id + 1)`` for 3 more: the same 6 poses within
    1e-5, in ``global_poses`` and in the trajectory file."""
    straight = _vo(tiny_kitti, tmp_path / "a", weights)
    straight.main(num_frames=6)

    first = _vo(tiny_kitti, tmp_path / "b", weights)
    first.main(num_frames=3)
    ckpt = first.save_state(str(tmp_path / "vo_state"))
    state = restore_variables(ckpt)["train_state"]
    assert {k: (v.dtype, tuple(v.shape)) for k, v in state.items()} == STATE_FIELDS
    assert state["pose_ids"].tolist() == [0, 1, 2] and int(state["tracking_stage"]) == 3

    resumed = _vo(tiny_kitti, tmp_path / "c")
    ref_id = resumed.load_state(ckpt)
    assert ref_id == 2
    assert all(torch.equal(resumed.variables[net][k], weights[net][k])
               for net in weights for k in weights[net])
    resumed.main(start_frame=ref_id + 1, num_frames=3)

    want = {i: p.pose for i, p in straight.global_poses.items()}
    assert sorted(resumed.global_poses) == sorted(want) == list(range(6))
    assert max(np.linalg.norm(p[:3, 3]) for p in want.values()) >= 100 * 1e-5
    for i in want:
        np.testing.assert_allclose(resumed.global_poses[i].pose, want[i], atol=1e-5,
                                   err_msg=f"pose {i} differs after resume")
    saved = load_poses_from_txt(str(tmp_path / "c" / "07.txt"))
    np.testing.assert_allclose(np.stack([saved[i] for i in range(6)]),
                               np.stack([want[i] for i in range(6)]), atol=1e-5)


def test_resume_restores_finetuned_weights_and_restarts_adam(tiny_kitti, weights, tmp_path):  # noqa: F811
    """With online finetuning the checkpoint holds the finetuned float32
    masters, which ``load_state`` puts back on the device; the Adam moments
    are not saved (as in the JAX package), so the resumed run starts Adam
    again at step 0."""
    vo = _vo(tiny_kitti, tmp_path / "a", weights, finetune=True)
    vo.main(num_frames=3)
    assert vo.opt_state["count"] == 2
    ckpt = vo.save_state(str(tmp_path / "vo_state"))
    fresh = _vo(tiny_kitti, tmp_path / "b", finetune=True)
    fresh.load_state(ckpt)
    for net, sd in vo.variables.items():
        assert all(torch.equal(fresh.variables[net][k], sd[k]) for k in sd), net
    assert fresh.opt_state["count"] == 0 and "opt_state" not in restore_variables(ckpt)


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"flow": {"conv.weight": torch.from_numpy(rng.randn(8, 4, 3, 3).astype(np.float32)),
                     "bn.running_mean": torch.zeros(8)}}


def test_save_restore_roundtrip(tmp_path):
    tree = _tree(0)
    save_variables(str(tmp_path / "ckpt"), tree, train_state={"step": torch.tensor(3)})
    got = restore_variables(str(tmp_path / "ckpt"))
    assert all(torch.equal(got["variables"]["flow"][k], v) for k, v in tree["flow"].items())
    assert int(got["train_state"]["step"]) == 3


def test_checkpoint_logger_keeps_the_newest_and_the_best(tmp_path):
    """tests/test_checkpoint.py's sequence of metrics (1.0, 0.5, 0.8) with
    ``keep_n=2``, and a fourth step: the two newest steps stay, the latest
    restores, and ``best/`` holds step 1 (metric 0.5)."""
    logger = CheckpointLogger(str(tmp_path / "ckpts"), keep_n=2)
    assert logger.restore_latest() == (None, None)
    for step, metric in [(0, 1.0), (1, 0.5), (2, 0.8), (3, None)]:
        logger.save(step, _tree(step), metric=metric)
    assert logger.steps() == [2, 3]
    step, payload = logger.restore_latest()
    assert step == 3
    assert torch.equal(payload["variables"]["flow"]["conv.weight"], _tree(3)["flow"]["conv.weight"])
    best = restore_variables(str(tmp_path / "ckpts" / "best"))
    assert torch.equal(best["variables"]["flow"]["conv.weight"], _tree(1)["flow"]["conv.weight"])
    # a new logger over the same directory finds the saved steps
    assert CheckpointLogger(str(tmp_path / "ckpts"), keep_n=2).restore_latest()[0] == 3
