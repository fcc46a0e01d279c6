"""The reference networks against the port's plain path at a tiny size
(float32 on the CPU, where the port runs its kernels' plain versions), and
the weights the benchmark makes against the port's parameter layout."""

import pytest
import torch

from perfbench.reference.frontend import ReferenceFrontend, make_variables


def port_frontend(kind, h, w):
    from dfvo_torch.pipeline.frontend import DeepFrontend

    from perfbench.core import program_config

    cfg = program_config(f"perfbench/configs/{'hd3' if kind == 'hd3' else 'lfn'}-md2r18.json",
                         {"frame_hw": [h, w]})
    cfg.tpu.dtype = "float32"
    return DeepFrontend(cfg, "cpu")


@pytest.mark.parametrize("kind,hw", [("liteflow", (64, 96)), ("hd3", (64, 128))])
def test_reference_matches_the_port_plain_path(kind, hw):
    variables = make_variables(kind, 3, "cpu", torch.float32)
    fe = port_frontend(kind, *hw)
    imgs = torch.rand(4, *hw, 3, generator=torch.Generator().manual_seed(1))
    got = fe.infer_chunk(fe.prepare_variables(variables), imgs)
    want = ReferenceFrontend(kind, *hw, pairs_per_block=2).infer_chunk(variables, imgs)
    for k in ("depths", "flow_fwd", "flow_diff"):
        assert got[k].shape == want[k].shape
        rel = float((got[k] - want[k]).norm() / want[k].norm())
        assert rel < 1e-4, (k, rel)


@pytest.mark.parametrize("kind", ["liteflow", "hd3"])
def test_weights_in_the_port_layout(kind):
    from dfvo_torch.models import HD3Net, LiteFlowNet, Monodepth2Depth
    from dfvo_torch.models.convert import init_state_dict

    meta = torch.device("meta")
    flow = LiteFlowNet(device=meta) if kind == "liteflow" else HD3Net(
        task="flow", encoder="dlaup", decoder="hda", corr_range=(4,) * 5, context=False,
        device=meta)
    v = make_variables(kind, 5, "cpu")
    for net, mod in (("flow", flow), ("depth", Monodepth2Depth(device=meta))):
        want = init_state_dict(mod, torch.Generator().manual_seed(0))
        assert list(v[net]) == list(want)
        assert all(v[net][k].shape == want[k].shape for k in want)
        assert all(v[net][k].dtype == torch.bfloat16 for k in want)


def test_weights_follow_the_seed():
    a, b = (make_variables("liteflow", s, "cpu") for s in (1, 1))
    c = make_variables("liteflow", 2, "cpu")
    k = "moduleFeatures.moduleOne.0.weight"
    assert torch.equal(a["flow"][k], b["flow"][k]) and not torch.equal(a["flow"][k], c["flow"][k])
    w = a["flow"][k].float()
    assert float(w.std()) == pytest.approx((3 * 7 * 7) ** -0.5, rel=0.1)  # lecun-normal
