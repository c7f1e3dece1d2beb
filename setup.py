"""Packaging (reference parity: setup.py for pip package Bez_IsaacGym)."""

from setuptools import find_packages, setup

setup(
    name="bez_isaacgym_tpu",
    version="0.1.0",
    description=("TPU-native simulation, MPC and RL framework for the Bez "
                 "humanoid (JAX/XLA re-design of Bez_IsaacGym)"),
    packages=find_packages(include=["bez_isaacgym_tpu*",
                                    "bez_isaacgym_tpu_torch*"]),
    package_data={"bez_isaacgym_tpu": ["assets/*.json",
                                       "assets/trajectories/*.json"],
                  "bez_isaacgym_tpu_torch": ["assets/*.json", "assets/*.npz",
                                             "assets/trajectories/*.json",
                                             "csrc/*"]},
    python_requires=">=3.10",
    install_requires=[
        "jax", "flax", "optax", "numpy", "scipy", "einops",
    ],
    extras_require={"dev": ["pytest", "matplotlib"]},
)
