"""VideoPrism in PyTorch, with hand-written Hopper (sm_90a) kernels.

The port of ``videoprism_tpu`` (JAX + Pallas for TPU), which stays the
reference.  This package imports torch and numpy only, never JAX.  So far
it runs the factorized video encoders, the video-text CLIP models and the
video classifiers, and serves the encoder and CLIP models in int8 (W8A8);
see ROADMAP.md for what is still to port.  Entry points
run on the card unless asked for the CPU (``device='cpu'``).

    import torch, videoprism_tpu_torch as vp
    model = vp.get_model('videoprism_public_v1_base', fprop_dtype=torch.bfloat16)
    params = vp.prepare_for_kernels(model.init(0)['params'])
    embeddings, _ = model.apply(params, video)   # [B, 16, 288, 288, 3] -> [B, 4096, 768]

    clip = vp.get_model('videoprism_lvt_public_v1_base', fprop_dtype=torch.bfloat16)
    params = vp.prepare_for_kernels(clip.init(0)['params'])
    video_emb, text_emb, _ = clip.apply(params, video, ids, paddings)  # [B, 768] each

    vc = vp.videoprism_vc_v1_large(vp.K400_NUM_CLASSES, dtype=torch.bfloat16)
    params = vp.prepare_for_kernels(vc.init(0)['params'])
    logits, _ = vc.apply(params, video)   # [B, 8, 288, 288, 3] -> [B, 400]

    # int8 (W8A8) serving from a local npz checkpoint (or weights/<name>.npz)
    encoder = vp.load_video_encoder('videoprism_public_v1_base', 'ckpt.npz',
                                    fprop_dtype=torch.bfloat16, quantize='int8')
    embeddings, _ = encoder(video)
    clip = vp.load_model('videoprism_lvt_public_v1_base', 'lvt.npz',
                         fprop_dtype=torch.bfloat16, quantize='int8')
    video_emb, text_emb, _ = clip(video, ids, paddings)
"""

from videoprism_tpu_torch.io.checkpoints import (
    load_checkpoint,
    params_from_numpy,
    prepare_for_kernels,
)
from videoprism_tpu_torch.models.registry import (
    CONFIGS,
    K400_NUM_CLASSES,
    MODELS,
    BoundModel,
    Model,
    get_model,
    has_model,
    load_classifier,
    load_model,
    load_pretrained_weights,
    load_video_encoder,
    videoprism_vc_v1_base,
    videoprism_vc_v1_giant,
    videoprism_vc_v1_large,
)
from videoprism_tpu_torch.quantization import quantize_for_serving

__all__ = [
    'CONFIGS', 'K400_NUM_CLASSES', 'MODELS', 'BoundModel', 'Model',
    'get_model', 'has_model', 'load_checkpoint', 'load_classifier',
    'load_model', 'load_pretrained_weights', 'load_video_encoder',
    'params_from_numpy', 'prepare_for_kernels', 'quantize_for_serving',
    'videoprism_vc_v1_base', 'videoprism_vc_v1_giant',
    'videoprism_vc_v1_large',
]
