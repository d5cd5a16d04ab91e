from setuptools import setup, find_packages

setup(
    name='mtscomp_tpu',
    version='0.1.0',
    description='Lossless compression for multichannel time series, decoded on a GPU',
    license='BSD-3-Clause',
    packages=find_packages(include=['mtscomp_tpu', 'mtscomp_tpu.*']),
    package_data={'mtscomp_tpu.native': ['*.cpp']},
    python_requires='>=3.9',
    install_requires=['numpy'],
    extras_require={'gpu': ['jax'], 'dev': ['pytest']},
    entry_points={
        'console_scripts': [
            'mtscomp=mtscomp_tpu.cli:mtscomp',
            'mtsdecomp=mtscomp_tpu.cli:mtsdecomp',
            'mtsdesc=mtscomp_tpu.cli:mtsdesc',
            'mtschop=mtscomp_tpu.cli:mtschop',
            'mtsmerge=mtscomp_tpu.cli:mtsmerge',
            'mtsrecompress=mtscomp_tpu.cli:mtsrecompress',
            'mtsverify=mtscomp_tpu.cli:mtsverify',
        ],
    },
)
