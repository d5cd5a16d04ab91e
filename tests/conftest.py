"""Shared fixtures.

- Puts JAX on a virtual 8-device CPU mesh (sharding tests run without
  a GPU; set before any jax import) unless ``JAX_PLATFORMS`` names
  another platform.
- Redirects the user config file into the test tmpdir so tests never
  touch ``~/.mtscomp`` (reference tests do the same, tests.py:54-58).
- Signal fixtures over several array types and dtypes; sizes chosen so
  the last chunk is partial.
"""

import os

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
flags = os.environ.get('XLA_FLAGS', '')
if 'xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (
        flags + ' --xla_force_host_platform_device_count=8').strip()

# The suite runs on the CPU backend, also on a machine with a GPU,
# unless JAX_PLATFORMS names another: ``JAX_PLATFORMS=cuda python -m
# pytest -m gpu tests/`` runs the tests marked ``gpu`` on the card.
import jax  # noqa: E402

if os.environ['JAX_PLATFORMS'] == 'cpu':
    jax.config.update('jax_platforms', 'cpu')

from pathlib import Path

import numpy as np
import pytest

import mtscomp_tpu.config as config_mod

N_CHANNELS = 19
SAMPLE_RATE = 1234.0
DURATION = 5.67
N_SAMPLES = int(SAMPLE_RATE * DURATION)  # 6997: chunks don't divide evenly


@pytest.fixture(autouse=True, scope='session')
def _isolate_user_config(tmp_path_factory):
    """Never read or write the real ~/.mtscomp during tests."""
    config_mod.CONFIG_PATH = tmp_path_factory.mktemp('cfg') / '.mtscomp'
    yield


@pytest.fixture(autouse=True)
def _pin_host_profile(monkeypatch):
    """Pin the measured host-codec rates so auto-routing tests are
    deterministic and the probe never runs (nor writes the real
    ~/.cache profile) inside the suite. Tests that exercise
    host_profile() itself override/clear this."""
    from mtscomp_tpu.parallel import pipeline
    monkeypatch.setattr(pipeline, '_HOST_PROFILE', (300e6, 250e6))


@pytest.fixture
def kernel_interpret(monkeypatch):
    """Route device decodes through the GPU decode kernel
    (``ops/gpu_rans.py``) in Pallas interpret mode on the CPU backend."""
    from mtscomp_tpu.parallel import pipeline
    monkeypatch.setattr(pipeline, 'DECODER', 'kernel')


@pytest.fixture
def gpu():
    """Skip unless JAX has a GPU; decided when the test runs."""
    import jax
    if jax.default_backend() != 'gpu':
        pytest.skip("needs a GPU (run on the card: python chip_smoke.py)")


@pytest.fixture
def tmp_path_(tmp_path, monkeypatch):
    """tmpdir with the user config redirected inside it."""
    monkeypatch.setattr(config_mod, 'CONFIG_PATH', tmp_path / '.mtscomp')
    yield tmp_path


def _white_sine(ns, nc):
    t = np.linspace(0.0, DURATION, ns)
    carrier = np.sin(2 * np.pi * 4.0 * t)[:, None]
    noise = np.random.normal(0.0, 0.2, size=(ns, nc))
    return carrier + noise


def _colored_noise(ns, nc):
    # Smooth noise: cumulative sum of white noise, mean-removed (random walk
    # has strongly correlated neighbors, like ephys LFP).
    w = np.random.normal(0.0, 1.0, size=(ns, nc))
    x = np.cumsum(w, axis=0)
    return x - x.mean(axis=0, keepdims=True)


ARRAY_KINDS = ('zeros', 'randn', 'white_sine', 'colored')


def make_signal(kind, ns=N_SAMPLES, nc=N_CHANNELS):
    np.random.seed(1234)
    if kind == 'zeros':
        return np.zeros((ns, nc))
    if kind == 'randn':
        return np.random.normal(size=(ns, nc))
    if kind == 'white_sine':
        return _white_sine(ns, nc)
    if kind == 'colored':
        return _colored_noise(ns, nc)
    raise ValueError(kind)


@pytest.fixture(params=ARRAY_KINDS)
def arr(request):
    return make_signal(request.param)


@pytest.fixture(params=['uint8', 'uint16', 'int8', 'int16', 'int32',
                        'int64'])
def dtype(request):
    return np.dtype(request.param)


@pytest.fixture(params=['zlib', 'ans'])
def algorithm(request):
    return request.param


def to_int16(x):
    """Scale a float array into the int16 range (reference helper analogue)."""
    m = np.abs(x).max() or 1.0
    return (x / m * 28000).astype(np.int16)


def write_arr(path, arr):
    Path(path).parent.mkdir(exist_ok=True, parents=True)
    arr.tofile(str(path))
    return path
