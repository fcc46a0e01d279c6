"""Self-supervised losses of online finetuning, on NHWC tensors.

Counterpart of ``dfvo_tpu/ops/losses.py``: SSIM, the 0.85·SSIM + 0.15·L1
reprojection loss and edge-aware smoothness.
"""

import torch
import torch.nn.functional as F


def _avg_pool3x3(x):
    """3x3 mean, stride 1, of the reflect-padded input (AvgPool2d(3, 1)
    after ReflectionPad2d(1)), NHWC."""
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    return F.avg_pool2d(xp, 3, stride=1).permute(0, 2, 3, 1)


def ssim(x, y):
    """Structural dissimilarity clamp((1 - SSIM) / 2, 0, 1) per pixel and
    channel of two [N x H x W x C] images in [0, 1]."""
    c1 = 0.01**2
    c2 = 0.03**2
    mu_x = _avg_pool3x3(x)
    mu_y = _avg_pool3x3(y)
    sigma_x = _avg_pool3x3(x**2) - mu_x**2
    sigma_y = _avg_pool3x3(y**2) - mu_y**2
    sigma_xy = _avg_pool3x3(x * y) - mu_x * mu_y
    ssim_n = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    ssim_d = (mu_x**2 + mu_y**2 + c1) * (sigma_x + sigma_y + c2)
    return torch.clamp((1 - ssim_n / ssim_d) / 2, 0.0, 1.0)


def reprojection_loss(pred, target):
    """Per-pixel photometric loss 0.85·SSIM + 0.15·L1, averaged over the
    channels: [N x H x W x 1]."""
    l1 = torch.mean(torch.abs(target - pred), dim=-1, keepdim=True)
    s = torch.mean(ssim(pred, target), dim=-1, keepdim=True)
    return 0.85 * s + 0.15 * l1


def smooth_loss(value, img):
    """Edge-aware first-order smoothness (a scalar) of a [N x H x W x C]
    map under the edges of a [N x H x W x 3] image."""
    grad_x = torch.abs(value[:, :, :-1, :] - value[:, :, 1:, :])
    grad_y = torch.abs(value[:, :-1, :, :] - value[:, 1:, :, :])
    img_gx = torch.mean(torch.abs(img[:, :, :-1, :] - img[:, :, 1:, :]), dim=-1, keepdim=True)
    img_gy = torch.mean(torch.abs(img[:, :-1, :, :] - img[:, 1:, :, :]), dim=-1, keepdim=True)
    grad_x = grad_x * torch.exp(-img_gx)
    grad_y = grad_y * torch.exp(-img_gy)
    return torch.mean(grad_x) + torch.mean(grad_y)
