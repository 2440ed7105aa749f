"""CLIP token ids of the empty prompt: the PyTorch package's own copy of what
it needs from vidseg_diffusion_tpu/io/tokenizer.py (numpy only; the two
packages share no module).

The VidSeg SD pipelines condition on the EMPTY prompt only
(sd_pipeline_vspw.py:277-307), whose token ids are fixed under the production
vocab layout and need no vocab file. The byte-pair encoder for other prompts
is not ported: it comes with the first path that sends one.
"""

from __future__ import annotations

import numpy as np

SOT = 49406
EOT = 49407
CONTEXT_LENGTH = 77


def tokenize_empty(batch: int = 1, context_length: int = CONTEXT_LENGTH) -> np.ndarray:
    """[SOT, EOT] zero-padded to `context_length`, as open_clip.tokenize
    frames the empty prompt."""
    tokens = np.zeros((batch, context_length), dtype=np.int32)
    tokens[:, 0] = SOT
    tokens[:, 1] = EOT
    return tokens
