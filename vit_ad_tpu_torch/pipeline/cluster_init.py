"""k-means cluster-centre init of the MDN's mu bias (port of
`vit_ad_tpu/pipeline/cluster_init.py`; reference init_cluster_centers,
src/util/TrainingsHelper.py:18-81, seed 42, commented out at its call site,
LearnerMDN.py:262-266).

k-means runs on the host over the frozen trunk's training patch tokens, and
the centres seed the mu bias, so that each mixture component starts near a
mode of the features. It is the JAX package's numpy/sklearn code, so the
centres of one input are those of the JAX function, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from vit_ad_tpu_torch.models.mdn import GaussianMDN

KMEANS_SEED = 42  # reference TrainingsHelper.py:65


def kmeans_cluster_centers(features: np.ndarray, num_clusters: int,
                           max_samples: int = 100_000) -> np.ndarray:
    """[N, P, D] (or [M, D]) features → [num_clusters, D] f32 centres: at most
    `max_samples` rows drawn without replacement, then sklearn's KMeans
    (n_init 10), or 25 Lloyd iterations in numpy where sklearn is missing."""
    flat = np.asarray(features, dtype=np.float32).reshape(-1, features.shape[-1])
    if flat.shape[0] > max_samples:
        idx = np.random.default_rng(KMEANS_SEED).choice(flat.shape[0], max_samples,
                                                        replace=False)
        flat = flat[idx]
    try:
        from sklearn.cluster import KMeans

        km = KMeans(n_clusters=num_clusters, random_state=KMEANS_SEED, n_init=10)
        km.fit(flat)
        return km.cluster_centers_.astype(np.float32)
    except ImportError:
        rng = np.random.default_rng(KMEANS_SEED)
        centers = flat[rng.choice(flat.shape[0], num_clusters, replace=False)]
        for _ in range(25):
            d = ((flat[:, None, :] - centers[None]) ** 2).sum(-1)
            assign = d.argmin(1)
            for c in range(num_clusters):
                pts = flat[assign == c]
                if len(pts):
                    centers[c] = pts.mean(0)
        return centers.astype(np.float32)


def seed_mdn_mu_bias(mdn: GaussianMDN, centers: np.ndarray) -> GaussianMDN:
    """Write the centres [K, D] into `mdn.mu.bias` in place and return the
    head. The bias index is e*K + k (output feature e of component k, the
    reference's layout), so it takes `centers.T` flattened: the JAX
    `b_mu = centers.T` [D, K]. The in-place write moves the parameter's
    version, so the cached kernel operands are made again."""
    k, d = mdn.num_gaussians, mdn.features
    if centers.shape != (k, d):
        raise ValueError(f"centers {centers.shape} for a head of K={k}, D={d}")
    with torch.no_grad():
        mdn.mu.bias.copy_(torch.from_numpy(np.ascontiguousarray(centers.T).reshape(-1)))
    return mdn
