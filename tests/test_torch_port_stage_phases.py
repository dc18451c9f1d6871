"""`tools/stage_phases.instrument`, on the CPU: the development copy of
`csrc/layer_stack.cu` that it makes stamps a call site of each of `SITES`,
inside the kernels that run them, and changes nothing else of the source.
The stamped copy is built and run on the card only."""
import re

import pytest

from phoregen_tpu_torch.ops import _build
from phoregen_tpu_torch.tools import stage_phases as sp


@pytest.fixture(scope="module")
def source():
    with open(_build.source_path("layer_stack")) as f:
        return f.read()


def test_every_site_kind_is_stamped(source):
    stamped, sites = sp.instrument(source)
    assert {callee for _, callee, _, _ in sites} == set(sp.SITES)
    assert [i for i, _, _, _ in sites] == list(range(len(sites)))
    assert len(sites) <= sp.MAX_SITES
    # each stamp opens a block, starts the clock and ends with its index
    for i, callee, _, _ in sites:
        assert re.search(r"\{ SITE_BEGIN " + callee + r"\b[^;]*;[^}]*"
                         rf"SITE_END\({i}\) \}}", stamped), (i, callee)
    # the kernels that stage A and B2 run hold stamped calls of their own
    enclosing = {encl for _, _, _, encl in sites}
    assert {"node_kernel", "node_body", "trip_att_kernel", "rows_gemm",
            "bond_attention", "edge_attention"} <= enclosing


def test_stamps_are_all_that_changes(source):
    stamped, sites = sp.instrument(source)
    assert stamped.count(sp.PRELUDE) == 1 and stamped.endswith(sp.READER)
    # the prelude comes before the first stamped call
    first = stamped.index("{ SITE_BEGIN ")
    assert stamped.index(sp.PRELUDE) < first
    plain = stamped.replace(sp.PRELUDE, "")[:-len(sp.READER)]
    plain = re.sub(r"\{ SITE_BEGIN (.*?) SITE_END\(\d+\) \}", r"\1", plain,
                   flags=re.S)
    assert plain == source
    # a line number names the line of the call in the source
    lines = source.splitlines()
    for _, callee, line, _ in sites:
        assert re.search(r"(?<![\w.>])" + callee + r"\b", lines[line - 1])


@pytest.mark.parametrize("body", sp.LOOP_BODIES)
def test_outer_loops_are_stamped(source, body):
    """`instrument(src, loops)` stamps the outermost `for` statements of
    stage B1's and stage C's bodies, nested call sites still stamped inside
    them, and taking the stamps off gives the source back."""
    stamped, sites = sp.instrument(source, (body,))
    loops = [(i, line) for i, callee, line, encl in sites if callee == "for"]
    assert loops and all(encl == body for _, c, _, encl in sites
                         if c == "for")
    assert {c for _, c, _, _ in sites} >= set(sp.SITES) - {"pos_body",
                                                          "trip_pre_body"}
    lines = source.splitlines()
    for _, line in loops:
        assert lines[line - 1].lstrip().startswith("for (")
    plain = stamped.replace(sp.PRELUDE, "")[:-len(sp.READER)]
    while "{ SITE_BEGIN " in plain:   # innermost stamps first
        plain = re.sub(r"\{ SITE_BEGIN ((?:(?!\{ SITE_BEGIN ).)*?) "
                       r"SITE_END\(\d+\) \}", r"\1", plain, flags=re.S)
    assert plain == source
