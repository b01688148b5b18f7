"""The kernel bound's arithmetic (``qoaudio_tpu_torch/utils/roofline.py``):
the SASS loop count split by pipe, the per-pipe and issue rates, and the
leanest of several builds.  The card's own numbers come from the chip run;
these pin the counting on hand-made SASS."""

import pytest

from qoaudio_tpu_torch.utils import roofline

CARD = roofline.Card("test card", sms=2, clock_mhz=1000.0)


def _sass(lines):
    """cuobjdump-style SASS, one instruction per 0x10 bytes from 0."""
    return "\n".join(f"        /*{16 * i:04x}*/                   {ins} ;"
                     f"   /* 0x{i:016x} */" for i, ins in enumerate(lines))


# one window: the load, 3 ALU ops (one predicated), 2 FMA-pipe ops, a
# uniform op and a store
_WINDOW = ["LDG.E.64 R2, desc[UR4][R4.64]", "LOP3.LUT R6, R2, 0x7, RZ, 0xc0, !PT",
           "@P0 IADD3 R7, R6, 0x1, RZ", "IMAD R8, R7, R9, RZ", "IMAD.MOV.U32 R9, RZ, RZ, R8",
           "SEL R10, R8, R9, P1", "UIADD3 UR4, UR4, 0x8, URZ",
           "STG.E.U16 desc[UR4][R12.64], R10"]


def _loop(windows):
    head = ["S2R R0, SR_TID.X", "IMAD R1, R0, 0x8, RZ"]  # outside the loop
    body = _WINDOW * windows
    back = f"@P2 BRA 0x{16 * len(head):x}"
    return head + body + [back, "EXIT"]


@pytest.mark.parametrize("windows", [1, 2, 4])
def test_sass_loop_splits_the_pipes_per_window(windows):
    c = roofline.sass_loop(_sass(_loop(windows)), r"LDG\.E\.64", 1)
    assert c["windows_per_pass"] == windows
    assert c["instructions"] == 8 * windows + 1  # the branch closes the loop
    assert (c["alu_per_window"], c["fma_per_window"]) == (3, 2)
    assert c["ops_per_window"] == 5
    assert c["instructions_per_window"] == pytest.approx((8 * windows + 1) / windows)


def test_sass_loop_takes_the_largest_innermost_loop():
    small = _WINDOW[:2] + ["@P3 BRA 0x0"]  # an innermost loop of 3
    lines = small + _loop(2)[2:]  # then a larger one, of 2 windows
    lines[-2] = f"@P2 BRA 0x{16 * len(small):x}"
    c = roofline.sass_loop(_sass(lines), r"LDG\.E\.64", 1)
    assert c["windows_per_pass"] == 2 and c["instructions"] == 17


def test_sass_loop_refuses_a_partial_window():
    with pytest.raises(ValueError, match="not a multiple"):
        roofline.sass_loop(_sass(_loop(3)), r"LDG\.E\.64", 2)


# (ALU, FMA, issued) -> which term binds: 2 SMs x 64 x 1 GHz per pipe,
# x 128 issued
@pytest.mark.parametrize("alu, fma, issued, want_ms", [
    (128e6, 64e6, 200e6, 1.0),  # the ALU pipe
    (32e6, 128e6, 200e6, 1.0),  # the FMA pipe
    (100e6, 100e6, 512e6, 2.0),  # the issue slots
])
def test_ops_ms_binds_on_the_slowest_pipe_or_issue(alu, fma, issued, want_ms):
    assert roofline.ops_ms(alu, fma, issued, CARD) == pytest.approx(want_ms)


def test_bound_ms_says_which_binds():
    ops = (128e6, 0.0, 128e6)  # 1 ms of operations
    ms, by = roofline.bound_ms(2 * 3.35e9, *ops, CARD)
    assert by == "bytes" and ms == pytest.approx(2.0)
    ms, by = roofline.bound_ms(3.35e9 / 2, *ops, CARD)
    assert by == "operations" and ms == pytest.approx(1.0)


def test_leanest_takes_the_build_with_the_least_time():
    def count(alu, fma, instr):
        return {"alu_per_window": alu, "fma_per_window": fma,
                "ops_per_window": alu + fma, "instructions_per_window": instr}

    lean = count(300, 300, 642)  # the issue slots bind it, at 321
    builds = [count(400, 246, 671), lean, count(330, 280, 640)]
    assert roofline.leanest(builds) is lean


# one window of a serial recurrence, 7 instructions deep: through a load,
# a predicate, IMAD.WIDE's register pair and a shuffle; two instructions
# off the path (one predicated, so it also waits on its own destination)
_STEP = ["LDG.E.U16 R2, desc[UR4][R4.64]", "IADD3 R6, R2, -R7, RZ",
         "ISETP.GE.AND P0, PT, R6, 0x10, PT", "SEL R8, R6, RZ, P0",
         "IMAD.WIDE R10, R8, R8, R10", "IADD3 R12, R11, 0x1, RZ",
         "LOP3.LUT R13, R9, 0x1, RZ, 0xc0, !PT", "@P0 IADD3 R7, R13, 0x1, RZ",
         "SHFL.BFLY PT, R14, R12, 0x8, 0x1f"]


def _chain_loop(body):
    head = ["S2R R0, SR_TID.X"]
    return head + body + ["@P2 BRA 0x10", "EXIT"]


def test_sass_chain_follows_registers_pairs_and_predicates():
    c = roofline.sass_chain(_sass(_chain_loop(_STEP)), r"LDG\.E\.U16", 1, 1)
    assert (c["chain"], c["steps"], c["block_instructions"]) == (7, 1, 10)
    c = roofline.sass_chain(_sass(_chain_loop(_STEP)), r"LDG\.E\.U16", 1, 7)
    assert c["chain_per_step"] == pytest.approx(1.0)


def test_sass_chain_carry_out_predicates_feed_the_high_word():
    body = ["LDG.E.U16 R2, desc[UR4][R4.64]", "IADD3 R6, P1, R2, R8, RZ",
            "IADD3.X R7, RZ, R9, RZ, P1, !PT", "IMAD R3, R7, R7, RZ"]
    c = roofline.sass_chain(_sass(_chain_loop(body)), r"LDG\.E\.U16", 1, 1)
    assert c["chain"] == 4


def test_sass_chain_takes_the_largest_straight_line_block():
    # a short block, a forward branch over one instruction, then a longer
    # block entered by that branch: the chain is the longer block's alone
    short = ["LDG.E.U16 R2, desc[UR4][R4.64]", "IADD3 R3, R2, 0x1, RZ", "@P1 BRA 0x50",
             "IADD3 R3, R3, 0x1, RZ"]
    longer = ["IADD3 R5, R3, 0x1, RZ", "IADD3 R6, R5, 0x1, RZ", "IADD3 R7, R6, 0x1, RZ",
              "IADD3 R8, R7, 0x1, RZ", "IADD3 R9, R1, 0x1, RZ"]
    c = roofline.sass_chain(_sass(_chain_loop(short + longer)), r"LDG\.E\.U16", 1, 2)
    assert (c["block_instructions"], c["chain"]) == (6, 4)  # the loop's branch ends it
    assert c["chain_per_step"] == pytest.approx(2.0)


# the decoder's software-pipelined window: the word comes through the
# read-only path two windows ahead, the next window's dequantizer (PRMT
# and a multiply, from registers loaded a pass earlier) stands beside the
# steps, and each step adds four dependent instructions to the carried
# prediction: IMAD on the newest sample, the fused >> 13 and + dq, and
# the two halves of the clamp; the older taps, the sign, the weight
# update and the store hang off that path
def _decode_step(prev, new):
    return [f"IMAD R20, R30, {prev}, R22", "LEA.HI.SX32 R20, R20, R40, 0x13",
            "VIMNMX R20, R20, -0x8000, !PT", f"VIMNMX {new}, R20, 0x7fff, PT",
            f"IMAD R22, R31, {prev}, RZ", f"SHF.R.S32.HI R23, RZ, 0x1f, {prev}",
            "LOP3.LUT R23, R23, 0x1, RZ, 0xfc, !PT", "IMAD R30, R23, R41, R30",
            f"STG.E.U16 desc[UR6][R10.64], {new}", "IADD3 R10, P0, R10, R50, RZ",
            "IMAD.X R11, R11, 0x1, R51, P0",
            "PRMT R42, R60, R61, R62", "IMAD R43, R42, R63, RZ"]


@pytest.mark.parametrize("steps", [2, 20])
def test_sass_counts_follow_the_decoders_pipelined_window(steps):
    body = ["LDG.E.64.CONSTANT R2, desc[UR6][R4.64]"]
    for k in range(steps):
        body += _decode_step(*(("R21", "R26") if k % 2 == 0 else ("R26", "R21")))
    sass = _sass(_chain_loop(body))
    c = roofline.sass_chain(sass, r"LDG\.E\.64", 1, steps)
    assert (c["steps"], c["chain"]) == (steps, 4 * steps + 1)  # + the last sample's store
    assert c["chain_per_step"] == pytest.approx(4.0 + 1 / steps)
    assert c["block_instructions"] == len(body) + 1  # the loop's branch ends it
    loop = roofline.sass_loop(sass, r"LDG\.E\.64", 1)
    assert loop["windows_per_pass"] == 1
    assert (loop["alu_per_window"], loop["fma_per_window"]) == (7 * steps, 5 * steps)
    assert loop["instructions_per_window"] == 13 * steps + 2  # the load and the branch
