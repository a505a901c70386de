"""Seeded inspection images, in memory: the texture and defect recipe of the
program's synthetic MVTec generator (`vit_ad_tpu_torch/data/synthetic.py`,
`_texture` and `_add_defect`), made in bulk with torch on the device instead
of one PIL image at a time, and handed back as host uint8 arrays.

A good image is a smooth texture: per-channel uniform values in [80, 160) on
an (S/8)² grid, resized bilinearly to S², plus N(0, 8²) noise, clipped to
[0, 255] and truncated to uint8. A defect is a disc of radius in [S/10, S/5)
centred in the middle half of the image, brightened by 90 and clipped.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def make_images(n: int, size: int, defects: int, gen: torch.Generator,
                device: torch.device) -> np.ndarray:
    """[n, size, size, 3] uint8 on the host; the first `defects` images
    carry a painted defect."""
    low = torch.rand((n, 3, size // 8, size // 8), generator=gen, device=device) * 80.0 + 80.0
    img = F.interpolate(low, size=(size, size), mode="bilinear", align_corners=False)
    img = img + torch.randn(img.shape, generator=gen, device=device) * 8.0
    if defects:
        lo, hi = size // 4, 3 * size // 4
        cy = torch.randint(lo, hi, (defects,), generator=gen, device=device)
        cx = torch.randint(lo, hi, (defects,), generator=gen, device=device)
        r = torch.randint(max(2, size // 10), max(3, size // 5), (defects,), generator=gen,
                          device=device)
        yy = torch.arange(size, device=device).view(1, size, 1)
        xx = torch.arange(size, device=device).view(1, 1, size)
        blob = ((yy - cy.view(-1, 1, 1)) ** 2 + (xx - cx.view(-1, 1, 1)) ** 2
                <= (r * r).view(-1, 1, 1))
        img[:defects] = img[:defects] + 90.0 * blob[:, None].float()
    img = img.clamp(0.0, 255.0).to(torch.uint8)  # truncation, as numpy's astype
    return np.ascontiguousarray(img.permute(0, 2, 3, 1).cpu().numpy())


def make_pool(batches: int, batch: int, size: int, defect_share: float, seed: int,
              device: torch.device) -> list:
    """`batches` distinct host batches [batch, size, size, 3] uint8, each
    with round(defect_share * batch) defect images at seeded places in it."""
    gen = torch.Generator(device=device).manual_seed(seed)
    defects = int(round(defect_share * batch))
    pool = []
    for _ in range(batches):
        imgs = make_images(batch, size, defects, gen, device)
        order = torch.randperm(batch, generator=gen, device=device).cpu().numpy()
        pool.append(np.ascontiguousarray(imgs[order]))
    return pool
