"""Package + native-extension build.

`pip install -e .` or `python setup.py build_ext --inplace` compiles the C++
host kernels (owlvit_tpu/native) as a plain shared library via g++ — no
pybind11 needed, bindings are ctypes. The library also self-builds lazily on
first import, so this step is optional.
"""

import subprocess
import sys
from pathlib import Path

from setuptools import Command, find_packages, setup


class BuildNative(Command):
    description = "compile owlvit_tpu/native C++ kernels"
    user_options = []

    def initialize_options(self):
        pass

    def finalize_options(self):
        pass

    def run(self):
        root = Path(__file__).parent / "owlvit_tpu" / "native"
        src = root / "src" / "owlvit_native.cpp"
        out = root / "libowlvit_native.so"
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", str(out), str(src)]
        print(" ".join(cmd))
        subprocess.run(cmd, check=True)


setup(
    name="owlvit_tpu",
    version="0.1.0",
    packages=find_packages(exclude=("tests",)),
    python_requires=">=3.10",
    install_requires=["jax", "optax", "orbax-checkpoint", "numpy", "pyyaml",
                      "pillow"],
    # owlvit_tpu_torch (the PyTorch/CUDA port) needs torch at run time; its
    # kernels build with nvcc at first use, its host C++ with g++
    extras_require={"torch": ["torch"]},
    package_data={"owlvit_tpu_torch": ["csrc/*.cu", "csrc/*.cuh", "native/src/*.cpp"]},
    cmdclass={"build_ext": BuildNative},
)
