"""The entry points of __graft_entry__.py under pytest.

entry() is the flagship step that compiles on the GPU, and
dryrun_multichip runs on virtual devices; covering them here keeps their
parity assertions part of the ordinary suite too.
"""

import os
import sys

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__ as graft  # noqa: E402


def test_entry_traces():
    """The flagship 1080p forward step traces/lowers cleanly on the CPU
    backend (on the GPU its Gram runs the Triton kernel)."""
    fn, args = graft.entry()
    lowered = jax.jit(fn).lower(*args)
    assert "1080" in str(lowered.in_avals)


def test_dryrun_multichip_parity():
    """Full hybrid DP x SP step on the 8-device virtual mesh; asserts the
    sharded results match the unsharded pipeline internally."""
    graft.dryrun_multichip(len(jax.devices()))
