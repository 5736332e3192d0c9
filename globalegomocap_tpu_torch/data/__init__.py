"""Data IO: the test_data.pkl contract, AMASS training data, HDF5 packing
and synthetic fixtures."""

from globalegomocap_tpu_torch.data.test_data import (  # noqa: F401
    TestChunk, load_test_chunk)
from globalegomocap_tpu_torch.data.synthetic import (  # noqa: F401
    synthetic_amass, synthetic_chunk)
