"""mtscomp_tpu: accelerator-native lossless compression for multichannel time series.

A ground-up JAX/XLA/Pallas re-design of the capabilities of
``int-brain-lab/mtscomp`` (reference: /root/reference/mtscomp.py):

- chunked delta + entropy coding of ``(n_samples, n_channels)`` arrays
  (reference scheme: mtscomp.py:375-397),
- ``.cbin`` + ``.ch`` offset-table container with random-access slicing
  (reference: mtscomp.py:514-859),
- a byte-identical legacy **zlib** path (format v1.0), and
- a new chunk- and lane-parallel **rANS** path (format v2.0) whose decode
  is a vectorized device program (see ``mtscomp_tpu.models.rans`` and
  ``mtscomp_tpu.ops``).

Public API mirrors the reference's ``__all__`` (mtscomp.py:43) plus the
device-side extensions.
"""

__version__ = '0.1.0'

# On-disk format versions. v1.0 is bit-compatible with the reference
# (mtscomp.py:41); v2.0 is this package's rANS container extension.
FORMAT_VERSION = '1.0'
FORMAT_VERSION_ANS = '2.0'

from .utils.misc import Bunch, add_default_handler  # noqa: E402,F401
from .config import read_config, write_config, config_path, CONFIG_PATH  # noqa: E402,F401
from .io_host import load_raw_data  # noqa: E402,F401
from .ops.delta import diff_along_axis, cumsum_along_axis  # noqa: E402,F401
from .api import Writer, Reader, compress, decompress, check  # noqa: E402,F401
from .stream import StreamWriter, StreamReader  # noqa: E402,F401
from .transcode import transcode  # noqa: E402,F401
from .verify import verify_file  # noqa: E402,F401

__all__ = (
    'load_raw_data', 'Writer', 'Reader', 'compress', 'decompress',
    'check', 'StreamWriter', 'StreamReader', 'transcode', 'verify_file',
    'read_config', 'write_config', 'Bunch',
    'add_default_handler', 'diff_along_axis', 'cumsum_along_axis',
)
