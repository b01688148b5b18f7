"""The side-by-side decode build tool
(``qoaudio_tpu_torch/experiments/decode_builds.py``) off the card: its
argument and ``ptxas -v`` parsing, and that it refuses a device that is not
CUDA.  Its builds, checks and times need nvcc and a card
(``python -m qoaudio_tpu_torch.experiments.decode_builds`` there)."""

import pytest

from qoaudio_tpu_torch.experiments import decode_builds
from qoaudio_tpu_torch.ops import cuda_decode
from qoaudio_tpu_torch.ops.decode import VARIANT_MODES

_PTXAS = """\
ptxas info    : 0 bytes gmem, 64 bytes cmem[3]
ptxas info    : Compiling entry function '_ZN3abc17qoa_decode_kernelILi4ELi256EEEvPKmPKiiiPs' for 'sm_90a'
ptxas info    : Function properties for _ZN3abc17qoa_decode_kernelILi4ELi256EEEvPKmPKiiiPs
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN3abc17qoa_decode_kernelILi0ELi64EEEvPKmPKiiiPs' for 'sm_90a'
ptxas info    : Function properties for _ZN3abc17qoa_decode_kernelILi0ELi64EEEvPKmPKiiiPs
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 63 registers, used 0 barriers
"""


@pytest.mark.parametrize("spec, want", [
    ("tree=csrc/qoa_decode.cu", ("tree", "csrc/qoa_decode.cu", ())),
    ("a=b.cu,-DX=1,-DY=2", ("a", "b.cu", ("-DX=1", "-DY=2"))),
])
def test_parse_spec(spec, want):
    assert decode_builds.parse_spec(spec) == want


def test_parse_spec_refuses_a_bare_path():
    with pytest.raises(ValueError, match="NAME=SOURCE"):
        decode_builds.parse_spec("qoa_decode.cu")


def test_registers_reads_the_production_kernel_and_the_worst_spill():
    assert decode_builds.registers(_PTXAS) == ((63, 0), 8)


def test_production_pattern_names_v0_at_64_threads():
    # the mangled template arguments: store mode index, then block size
    assert decode_builds.PRODUCTION == f"qoa_decode_kernelILi{VARIANT_MODES.index('v0')}ELi64E"
    assert 64 in cuda_decode.VARIANT_THREADS
    assert set(decode_builds.PROBE_MODES) | set(decode_builds.MAIN_MODES) <= set(VARIANT_MODES)


def test_run_refuses_a_cpu_device():
    with pytest.raises(ValueError, match="CUDA"):
        decode_builds.run([], device="cpu")
