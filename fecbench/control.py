"""The control: the plain reference put in the program's place with one
guarantee of the configuration broken, the step that would tempt a later
change.  The check has to find it wrong.  Each reference module says
which guarantee its `control` breaks (fecbench/reference/<family>.py):

- RS: Berlekamp-Massey cut to half of its num_roots trips;
- LDPC: the iteration budget cut from the configuration's to 3.

The system runs no model and states no number precision, so a broken
guarantee stands where a lower precision would.
"""

from __future__ import annotations

import collections

from fecbench import generator

Result = collections.namedtuple("Result", "ok data parity corrected")


class ControlDecoder:
    """A decode-only stand-in for the facade, or the sharded codec, on the
    mix's first device."""

    def __init__(self, ref):
        self.ref = ref

    def decode(self, **inputs):
        return Result(*generator.blocks(self.ref.decode, rows=generator.REF_ROWS, **inputs))


def system(mix):
    """The control standing in for the mix's whole system under test."""
    module = generator.reference_module(mix.config, mix.traffic)
    return ControlDecoder(module.control(mix.config, mix.dev))
