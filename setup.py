from setuptools import find_packages, setup

setup(
    name="neural-waveshaping-synthesis-tpu",
    version="0.1.0",
    description=(
        "TPU-native (JAX/XLA) neural waveshaping synthesis: NEWT "
        "re-designed for TPU hardware"
    ),
    packages=find_packages(
        include=[
            "neural_waveshaping_synthesis_tpu*",
            "neural_waveshaping_synthesis_tpu_torch*",
        ]
    ),
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "scipy",
        "optax",
        "orbax-checkpoint",
        "click",
        "pandas",
        "tqdm",
    ],
    extras_require={
        "convert": ["torch"],
        "logging": ["wandb"],
        "test": ["pytest", "torch"],
    },
)
