"""The port's plain RS decode against the Pallas kernel it replaces.

`RSPallasDecoder.decode_plain` (libpoporon_tpu/models/rs_pallas.py) runs
in interpret mode on the CPU, as tests/test_pallas.py runs it, at one
128-codeword block; the port's plain version (the CUDA kernel's plain
PyTorch twin) must agree on every output.  The erasure mode is not
compared here: on inputs whose locator degree exceeds the erasure count
the Pallas kernel differs from the XLA path, which the port follows.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from libpoporon_tpu.config import RSConfig as JaxRSConfig  # noqa: E402
from libpoporon_tpu.models.rs import RSCodec as JaxRSCodec  # noqa: E402
from libpoporon_tpu.models.rs_pallas import RSPallasDecoder  # noqa: E402

from libpoporon_tpu_torch.config import RSConfig  # noqa: E402
from libpoporon_tpu_torch.models.rs import RSCodec  # noqa: E402

from test_torch_rs import assert_same, mixed_batch  # noqa: E402

torch.set_num_threads(2)


def test_plain_decode_matches_pallas_interpret(monkeypatch):
    monkeypatch.setattr(RSPallasDecoder, "_interpret",
                        jax.devices()[0].platform != "tpu")
    dec = RSPallasDecoder(JaxRSCodec(JaxRSConfig(use_pallas="off")), lanes=128)
    rs = RSCodec(RSConfig(), "cpu")
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, (128, 223), dtype=np.uint8)
    parity = rs.encode(data).numpy()
    bad, pbad = mixed_batch(rng, data, parity)
    assert_same(rs.decode(bad, pbad), dec.decode_plain(bad, pbad))
