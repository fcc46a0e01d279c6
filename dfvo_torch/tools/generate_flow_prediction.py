"""Export LiteFlowNet's flows in the KITTI Flow 2012/2015 PNG format.

    python -m dfvo_torch.tools.generate_flow_prediction \
        --dataset kitti2015 --data_dir DATA --result RESULT \
        [--flow_mask_thre 0.1] [--model network-default.pytorch] [--device cuda|cpu]

The flags and the files of ``tools/generate_flow_prediction.py``, plus
``--device``. For each ``*_10.png`` in ``--data_dir`` and
its ``*_11.png``, the two images are resized (cv2) to their size rounded up
to multiples of 32, LiteFlowNet runs once over the pair and its reverse,
and the forward flow, resized to the image, is written as a 16-bit KITTI
flow PNG of the same name in ``--result``. With ``--flow_mask_thre`` the
pixels whose forward-backward inconsistency is not below it get flow 0 and
are marked invalid. ``--model`` is a reference LiteFlowNet checkpoint; the
weights are drawn from the configuration's seed when it is absent. The
network runs in the default configuration's dtype (``tpu.dtype``,
bfloat16), on the card unless ``--device cpu`` is given.
"""

import argparse
import os
from glob import glob

import numpy as np
import torch

from ..flowlib import write_kitti_png_flow
from ..pipeline.frontend import DeepFrontend, forward_backward_consistency, resize_dense_flow
from ..utils import ConfigLoader

CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                   "options", "examples", "default_configuration.yml")
PROGRESS_EVERY = 20


def feed_size(h, w):
    """(h, w) rounded up to multiples of 32."""
    return -(-h // 32) * 32, -(-w // 32) * 32


class FlowExport:
    """LiteFlowNet at the feed size of ``image_hw``'s images."""

    def __init__(self, image_hw, model=None, device="cuda"):
        self.h, self.w = image_hw
        th, tw = feed_size(self.h, self.w)
        cfg = ConfigLoader().merge_cfg([CFG])
        cfg.image.height, cfg.image.width = th, tw
        cfg.deep_flow.network = "liteflow"
        cfg.deep_flow.flow_net_weight = model
        self.frontend = DeepFrontend(cfg, device)
        variables = self.frontend.load_variables(torch.Generator().manual_seed(int(cfg.seed)))
        self.variables = self.frontend.prepare_variables({"flow": variables["flow"]})
        self.seeded = not (model and os.path.isfile(model))

    def prepare(self, img):
        """[H x W x 3] RGB uint8 -> [th x tw x 3] float in [0, 1] on the
        device (cv2's resize, as the JAX tool feeds it)."""
        import cv2

        th, tw = self.frontend.h, self.frontend.w
        img = cv2.resize(img, (tw, th)).astype(np.float32) / 255.0
        return torch.from_numpy(img).to(self.frontend.device)

    @torch.no_grad()
    def __call__(self, img1, img2):
        """(forward flow [H x W x 2], forward-backward inconsistency
        [H x W]) of the pair (img1 -> img2), on the device."""
        a, b = self.prepare(img1), self.prepare(img2)
        feed = torch.stack([a, b]).to(self.frontend.dtype)
        flows = self.frontend._flow(self.variables, feed, feed.flip(0), "shared")
        full = resize_dense_flow(flows, self.h, self.w)
        diff = forward_backward_consistency(full[0:1], full[1:2])
        return full[0], diff[0]


def read_rgb(path):
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def main(argv=None):
    parser = argparse.ArgumentParser(description="flow prediction export")
    parser.add_argument("--dataset", choices=["kitti2012", "kitti2015"], default="kitti2015")
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--result", required=True)
    parser.add_argument("--model", default=None, help="torch .pytorch weights")
    parser.add_argument("--flow_mask_thre", type=float, default=None,
                        help="forward-backward consistency threshold; invalid flows get 0")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    os.makedirs(args.result, exist_ok=True)
    img_paths = sorted(glob(os.path.join(args.data_dir, "*_10.png")))
    if not img_paths:
        raise FileNotFoundError(f"no *_10.png in {args.data_dir}")
    h, w = read_rgb(img_paths[0]).shape[:2]
    export = FlowExport((h, w), args.model, args.device)
    if export.seeded:
        print("==> WARNING: seeded random flow weights (no --model given)")
    for n, p1 in enumerate(img_paths, 1):
        flow, diff = export(read_rgb(p1), read_rgb(p1.replace("_10.png", "_11.png")))
        flow = flow.cpu().numpy()
        mask = None
        if args.flow_mask_thre is not None:
            mask = diff.cpu().numpy() < args.flow_mask_thre
            flow = flow * mask[..., None]
        write_kitti_png_flow(flow, os.path.join(args.result, os.path.basename(p1)), mask)
        if n % PROGRESS_EVERY == 0 or n == len(img_paths):
            print(f"==> {n}/{len(img_paths)} flows written to {args.result}")
    return export


if __name__ == "__main__":
    main()
