"""Package + native-extension build.

The _raybatch C extension implements the host-side ray kernel (see
native/raybatch.c); everything degrades gracefully to numpy when it is
not built. Build in place with:

    python setup.py build_ext --inplace
"""
import numpy
from setuptools import Extension, find_packages, setup

setup(
    name='autolabel_tpu',
    version='0.1.0',
    description=('TPU-native interactive neural-field scene labeling '
                 '(capabilities of ethz-asl/autolabel)'),
    packages=find_packages(include=['autolabel_tpu', 'autolabel_tpu.*',
                                    'autolabel_tpu_torch',
                                    'autolabel_tpu_torch.*']),
    package_data={'autolabel_tpu_torch': ['csrc/*.cu']},
    ext_modules=[
        Extension('autolabel_tpu._raybatch',
                  sources=['native/raybatch.c'],
                  include_dirs=[numpy.get_include()],
                  extra_compile_args=['-O3']),
    ],
    python_requires='>=3.10',
)
