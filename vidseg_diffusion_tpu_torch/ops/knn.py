"""K-nearest-neighbour label vote (PyTorch port of ops/knn.py).

Replaces sklearn KNeighborsClassifier(n_neighbors=4) of the cross-frame label
propagation (feature_extraction.py:608-613): squared Euclidean distances as
|x|^2 - 2 x.ref^T + |ref|^2 in fp32 (the JAX formula, neither clamped nor
reordered as torch.cdist would), the k nearest, and a one-hot vote whose
argmax takes the smallest label on a tie (sklearn's mode()). The [N, M]
distance matrix is one library product, as in JAX, where it runs outside any
Pallas kernel: at a carried-state window of the full-width SVD path it is
[20384, 20384] fp32, 1.66 GB on the device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def knn_distances(ref_x: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[N, M] squared distances of x [N, D] to ref_x [M, D] in fp32."""
    ref_x, x = ref_x.float(), x.float()
    x2 = (x * x).sum(dim=1, keepdim=True)
    r2 = (ref_x * ref_x).sum(dim=1)
    return x2 - 2.0 * (x @ ref_x.T) + r2[None, :]


def knn_predict(ref_x: torch.Tensor, ref_y: torch.Tensor, x: torch.Tensor, k: int = 4,
                num_classes: int = 256) -> torch.Tensor:
    """Labels [N] (int64) of x [N, D] by a vote of its k nearest rows of ref_x
    [M, D], whose labels ref_y [M] are dense indices in [0, num_classes)."""
    idx = torch.topk(knn_distances(ref_x, x), k, dim=1, largest=False).indices       # [N, k]
    counts = F.one_hot(ref_y.to(idx.device)[idx].long(), num_classes).sum(dim=1)    # [N, C]
    return torch.argmax(counts, dim=1)   # the first maximum: the smallest label
