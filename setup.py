"""Packaging for voge_tpu (reference parity: VoGE's setup.py builds the CUDA
extension; ours optionally pre-builds the ctypes C++ helper — which otherwise
builds lazily on first use — and has no hard native dependency)."""
import os
import subprocess

from setuptools import find_packages, setup
from setuptools.command.build_py import build_py


class BuildWithNative(build_py):
    def run(self):
        src = os.path.join("voge_tpu", "native", "voge_native.cpp")
        out = os.path.join("voge_tpu", "native", "_voge_native.so")
        try:
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", out],
                check=True,
            )
        except Exception as e:  # pure-Python fallbacks exist
            print(f"voge_tpu: skipping native build ({e})")
        super().run()


setup(
    name="voge_tpu",
    version="0.1.0",
    description=(
        "TPU-native differentiable volume renderer using Gaussian ellipsoids "
        "(JAX/XLA/Pallas)"
    ),
    # voge_tpu_torch: the PyTorch + CUDA port (needs torch; its kernels are
    # compiled by nvcc from the shipped csrc/ sources at first launch)
    packages=find_packages(include=["voge_tpu", "voge_tpu.*",
                                    "voge_tpu_torch", "voge_tpu_torch.*"]),
    package_data={"voge_tpu.native": ["voge_native.cpp"],
                  "voge_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=["numpy", "jax", "optax"],
    cmdclass={"build_py": BuildWithNative},
)
