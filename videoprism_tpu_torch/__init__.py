"""VideoPrism in PyTorch, with hand-written Hopper (sm_90a) kernels.

The port of ``videoprism_tpu`` (JAX + Pallas for TPU), which stays the
reference.  This package imports torch and numpy only, never JAX.  So far
it runs the factorized video encoders and the video-text CLIP models; see
ROADMAP.md for what is still to port.  Entry points run on the card unless
asked for the CPU (``device='cpu'``).

    import torch, videoprism_tpu_torch as vp
    model = vp.get_model('videoprism_public_v1_base', fprop_dtype=torch.bfloat16)
    params = vp.prepare_for_kernels(model.init(0)['params'])
    embeddings, _ = model.apply(params, video)   # [B, 16, 288, 288, 3] -> [B, 4096, 768]

    clip = vp.get_model('videoprism_lvt_public_v1_base', fprop_dtype=torch.bfloat16)
    params = vp.prepare_for_kernels(clip.init(0)['params'])
    video_emb, text_emb, _ = clip.apply(params, video, ids, paddings)  # [B, 768] each
"""

from videoprism_tpu_torch.io.checkpoints import (
    load_checkpoint,
    params_from_numpy,
    prepare_for_kernels,
)
from videoprism_tpu_torch.models.registry import (
    CONFIGS,
    MODELS,
    Model,
    get_model,
    has_model,
    load_pretrained_weights,
)

__all__ = [
    'CONFIGS', 'MODELS', 'Model', 'get_model', 'has_model',
    'load_checkpoint', 'load_pretrained_weights', 'params_from_numpy',
    'prepare_for_kernels',
]
