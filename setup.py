"""videoprism_tpu package setup (pip-installable, mirrors reference setup.py)."""

from setuptools import find_packages, setup

setup(
    name='videoprism_tpu',
    version='0.1.0',
    description=(
        'TPU-native VideoPrism: factorized video encoders, video-text CLIP '
        'and classification in JAX/XLA/Pallas with GSPMD sharding.'),
    long_description=open('README.md').read(),
    long_description_content_type='text/markdown',
    packages=find_packages(include=['videoprism_tpu*']),
    package_data={
        'videoprism_tpu': ['assets/demo.mp4', 'assets/testdata/*.model',
                           'native/*.cc'],
        # The PyTorch port's hand-written CUDA kernels, built with nvcc at
        # first use on the card.
        'videoprism_tpu_torch': ['csrc/*.cu', 'csrc/*.cuh'],
    },
    python_requires='>=3.10',
    install_requires=[
        'jax>=0.4.30',
        'numpy>=1.26',
        'optax',
    ],
    extras_require={
        # Video decode (host side); the device pipeline has no cv2 dep.
        'video': ['opencv-python'],
        # Checkpoint download from HuggingFace.
        'hub': ['huggingface-hub'],
        'safetensors': ['safetensors'],
        # Training checkpoint/resume (train.checkpointing imports orbax
        # at module level).
        'train': ['orbax-checkpoint'],
        'test': ['pytest', 'chex', 'flax', 'einshape', 'einops'],
    },
    license='Apache 2.0',
)
