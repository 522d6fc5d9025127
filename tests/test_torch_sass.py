"""``corrosion_tpu_torch.kernels.sass``: the SASS listing's parse, its
pipes and loops, on a listing written here (``cuobjdump``
runs only where the CUDA toolkit is)."""

import pytest

from corrosion_tpu_torch.kernels import sass

LISTING = """
	code for sm_90a
		Function : _Z4loopPj
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;        /* 0x00000a00ff017b82 */
        /*0010*/                   S2R R0, SR_TID.X ;            /* 0x0000000000007919 */
.L_x_1:
        /*0020*/                   IMAD R2, R0, UR4, R2 ;
        /*0030*/                   IMAD.WIDE.U32 R4, R2, UR5, RZ ;
        /*0040*/                   LOP3.LUT R3, R4, R5, R2, 0xfe, !PT ;
        /*0050*/                   SHF.L.W.U32.HI R6, R3, 0xd, R3 ;
        /*0060*/                   ISETP.GT.U32.AND P0, PT, R3, UR6, PT ;
        /*0070*/              @!P0 BRA `(.L_x_2) ;
        /*0080*/                   ATOMS.ADD R7, [UR7], R8 ;
        /*0090*/                   STS.64 [R7], R2 ;
.L_x_2:
        /*00a0*/                   IADD3 R0, R0, 0x100, RZ ;
        /*00b0*/                   UIADD3 UR8, UR8, 0x1, URZ ;
        /*00c0*/               @P1 BRA `(.L_x_1) ;
        /*00d0*/                   EXIT ;
		Function : _Z5otherv
        /*0000*/                   EXIT ;
"""


def test_listing_parses_into_functions_with_resolved_branches():
    fns = sass.functions(LISTING)
    assert sorted(fns) == ["_Z4loopPj", "_Z5otherv"]
    insns = fns["_Z4loopPj"]
    assert [op for _, op, _ in insns][:3] == ["LDC", "S2R", "IMAD"]
    branches = {a: t for a, op, t in insns if op == "BRA"}
    assert branches == {0x70: 0xA0, 0xC0: 0x20}


@pytest.mark.parametrize("op, pipe", [
    ("IMAD", "fma"), ("IMAD.WIDE.U32", "fma"), ("IMAD.IADD", "fma"),
    ("IADD3", "alu"), ("LOP3.LUT", "alu"), ("SHF.L.W.U32.HI", "alu"),
    ("ISETP.GT.U32.AND", "alu"), ("LDG.E.64", "lsu"), ("ATOMS.ADD", "lsu"),
    ("STS.64", "lsu"), ("UIADD3", "uniform"), ("BRA", "control"),
    ("BAR.SYNC.DEFER_BLOCKING", "control"), ("F2I.U32", "other"),
])
def test_opcodes_go_to_their_pipes(op, pipe):
    assert sass.pipe_of(op) == pipe


def test_loops_and_their_pipe_counts():
    insns = sass.functions(LISTING)["_Z4loopPj"]
    (loop,) = sass.loops(insns)
    assert (loop["start"], loop["end"], loop["n"]) == ("0x20", "0xc0", 11)
    assert loop["pipes"] == {"alu": 4, "control": 2, "fma": 2, "lsu": 2,
                             "uniform": 1}
    assert loop["ops"]["ATOMS.ADD"] == 1
    # the straight-line code outside the loop is not counted in it
    assert "EXIT" not in loop["ops"] and "S2R" not in loop["ops"]


def test_a_written_listing_reads_back_without_the_toolkit(tmp_path):
    listing = tmp_path / "libloop-0123456789ab.sass"
    listing.write_text(LISTING)
    got = sass.mix(listing, "loop")
    (name,) = got
    assert name == "_Z4loopPj"
    assert got[name]["n"] == 14 and got[name]["loops"][0]["n"] == 11
