"""BER waterfall of the LDPC decoder, on the card by default.

Counterpart of benchmarks/waterfall.py: sweeps Eb/N0 (SNR) over an
AWGN/BPSK channel and reports the raw channel BER against the post-decode
BER and FER at each point.  The data and the channel noise come from the
same numpy generator as in the JAX script, so for the same arguments both
print the same lines; the decode is the port's `LDPCCodec`
(`decode_soft_adaptive`, or `decode_hard_adaptive` with --hard), which on
the card runs the BP kernel (csrc/ldpc_bp.cu).

Usage:
    python -m libpoporon_tpu_torch.benchmarks.waterfall [--block 128]
        [--rate 1/2] [--batch 4096] [--snrs 2.0,2.5,...] [--iters 50]
        [--hard] [--seed 0] [--device cuda]

Prints one JSON line per SNR point:
    {"snr_db": 3.0, "raw_ber": ..., "ber": ..., "fer": ..., "avg_iters": ...}
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..config import LdpcConfig, LdpcRate
from ..models.ldpc import LDPCCodec
from ..utils import bits as bitutils
from ..utils.faults import awgn_llrs

RATES = {
    "1/3": "RATE_1_3", "1/2": "RATE_1_2", "2/3": "RATE_2_3",
    "3/4": "RATE_3_4", "4/5": "RATE_4_5", "5/6": "RATE_5_6",
}


def sweep(codec: LDPCCodec, batch: int, snrs, iters: int, hard: bool, seed: int):
    """Yields one result dict per SNR point, decoding `batch` random
    codewords of `codec` at each."""
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 256, (batch, codec.info_bytes), dtype=np.uint8)
    parity = codec.encode(info).cpu().numpy()
    cb = bitutils.unpack_np(np.concatenate([info, parity], axis=1), codec.codeword_bits)
    info_bits_ref = cb[:, : codec.info_bits]
    for snr in snrs:
        llr = awgn_llrs(cb, snr_db=snr, rng=int(rng.integers(1 << 31)))
        raw_ber = float(((llr < 0).astype(np.uint8) != cb).mean())
        if hard:
            cw_in = bitutils.pack_np((llr < 0).astype(np.uint8))
            ok, out, it = codec.decode_hard_adaptive(cw_in, iters)
        else:
            ok, out, it = codec.decode_soft_adaptive(llr, iters)
        out_bits = bitutils.unpack_np(out.cpu().numpy(), codec.codeword_bits)
        ber = float((out_bits[:, : codec.info_bits] != info_bits_ref).mean())
        yield {
            "snr_db": snr,
            "raw_ber": round(raw_ber, 6),
            "ber": round(ber, 8),
            "fer": round(float((~ok.cpu().numpy()).mean()), 6),
            "avg_iters": round(float(it.cpu().numpy().mean()), 2),
        }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--rate", default="1/2", choices=sorted(RATES))
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--snrs", default="2.0,2.5,3.0,3.5,4.0,4.5,5.0")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--hard", action="store_true",
                    help="hard-decision decode of the sliced channel bits")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    codec = LDPCCodec(
        LdpcConfig(block_size=args.block, rate=getattr(LdpcRate, RATES[args.rate])),
        args.device)
    snrs = [float(s) for s in args.snrs.split(",")]
    for line in sweep(codec, args.batch, snrs, args.iters, args.hard, args.seed):
        print(json.dumps(line), flush=True)
    return codec


if __name__ == "__main__":
    main()
