"""The frozen byte formulas on hand-counted shapes, the kernel names,
the counting wrappers and the trace arithmetic."""
import types

import pytest
import torch

from rdfbench import devtrace, roofline


def test_formulas_on_hand_counted_shapes():
    # 3 probes, 5 keys: 8 int32 read, 6 written (lo, cnt)
    assert roofline.join_range_bytes(3, 5) == 4 * 8 + 4 * 6
    # 2 query pairs, 4 live table pairs, 2 mask bytes
    assert roofline.pair_semijoin_bytes(2, 4, 2) == 16 + 32 + 2
    # a (3, 2) table read and written (48), 3 flags read, 3 written
    assert roofline.dedup_masked_bytes(3, 2) == 48 + 6
    # (4, 2) table 32, flags and probes 4 + 16, live keys 10 + 6 = 64;
    # 3 + 0 rows produced, each payload 4, row 8, column 4, flag 1 (17);
    # 2 overflow counts
    assert roofline.fused_join_bytes(4, 2, [10, 6], [3, 0]) == \
        32 + 20 + 64 + 3 * 17 + 8


def test_kernel_table_rows_at_their_shapes():
    """The program's kernel table gives the bounds at C = 4 x 2^18,
    V = 4, T = 1,430,768 and 3.35 TB/s: row 1 (counts only) 0.00421 ms,
    row 2 0.00623 ms, row 3 0.01064 ms."""
    C, T, bw = 4 << 18, 1430768, 3.35e12
    assert (2 * C + T) * 4 / bw * 1e3 == pytest.approx(0.00421, abs=1e-5)
    assert roofline.pair_semijoin_bytes(C, T, C) / bw * 1e3 == \
        pytest.approx(0.00623, abs=1e-5)
    assert roofline.dedup_masked_bytes(C, 4) / bw * 1e3 == \
        pytest.approx(0.01064, abs=1e-5)


@pytest.mark.parametrize("name,want", [
    ("(anonymous namespace)::scan_kernel(unsigned char const*, int)",
     "scan_kernel"),
    ("void rt::dedup_insert_kernel(int const*, int)", "dedup_insert_kernel"),
    ("gather_kernel(int const*, rt::Sites, int, int*)", "gather_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, float>(int)", None),
    ("Memset (Device)", "Memset"),
])
def test_base_names(name, want):
    assert roofline.base_name(name) == want
    assert roofline.is_join_kernel(name) == (want in
                                             roofline.JOIN_FUNCTIONS)


def test_counting_wrappers_sum_only_while_recording():
    def fused(bind, valid, probe, keys, payload, cap, windows=None):
        m = keys.shape[0]
        nv = torch.zeros(m, cap, dtype=torch.bool)
        nv[0, :3] = True
        return (torch.zeros(m, cap, bind.shape[1]), None, nv, None)

    mod = types.SimpleNamespace(
        join_range=lambda probe, keys: (probe, probe),
        pair_semijoin_runs=lambda qs, qo, ts, to, runs=1, w=None:
            torch.zeros(qs.shape, dtype=torch.bool),
        dedup_rows_masked=lambda b, v: (b, v),
        fused_join_sites=fused)
    c = roofline.CountingJoins()
    with c.installed(mod):
        mod.join_range(torch.zeros(3), torch.zeros(5))     # not recorded
        c.recording = True
        mod.join_range(torch.zeros(3), torch.zeros(5))
        mod.pair_semijoin_runs(torch.zeros(2), torch.zeros(2),
                               torch.zeros(4), torch.zeros(4), 1, None)
        mod.dedup_rows_masked(torch.zeros(3, 2), torch.zeros(3))
        w = types.SimpleNamespace(lives=(10, 6))
        mod.fused_join_sites(torch.zeros(4, 2), torch.zeros(4),
                             torch.zeros(4), torch.zeros(2, 16),
                             torch.zeros(2, 16), 8, w)
    assert c.calls == 4
    assert c.bytes() == (roofline.join_range_bytes(3, 5)
                         + roofline.pair_semijoin_bytes(2, 4, 2)
                         + roofline.dedup_masked_bytes(3, 2)
                         + roofline.fused_join_bytes(4, 2, [10, 6], [3, 0]))
    assert mod.join_range.__name__ == "<lambda>"    # restored


def test_trace_summary():
    recs = [
        # device: a join kernel 1.0-1.2, torch's 1.1-1.5, a join 2.0-2.1
        ("(anonymous namespace)::expand_kernel(int)", 1.0, 1.2, True, 0),
        ("void at::native::elementwise_kernel<1>(int)", 1.1, 1.5, True, 0),
        ("rt::dedup_insert_kernel(int)", 2.0, 2.1, True, 0),
        ("(anonymous namespace)::scan_kernel(int)", 3.0, 3.2, True, 0),
        # the dispatcher: aten::cat holds the first gap's middle (1.75),
        # nothing the second's (2.55); another thread runs one op
        ("aten::cat", 1.6, 1.9, False, 7),
        ("aten::copy_", 1.7, 1.8, False, 7),
        ("aten::nonzero", 2.8, 2.9, False, 7),
        ("aten::zeros", 1.74, 1.76, False, 9),
        # the profiled part, and what lies outside it
        ("rdfbench.profiled", 0.5, 4.5, False, 1),
        ("aten::cat", 4.6, 4.9, False, 7),
        ("(anonymous namespace)::scan_kernel(int)", 4.4, 4.7, True, 0),
    ]
    t = devtrace.summarize(recs, "rdfbench.profiled")
    assert t.window_s == pytest.approx(4.0)
    assert t.busy_s == pytest.approx(0.5 + 0.1 + 0.2 + 0.1)
    assert t.join_device_s == pytest.approx(0.2 + 0.1 + 0.2 + 0.1)
    assert dict(t.device_ops)["at::native::elementwise_kernel"] == pytest.approx(0.4)
    gaps = dict(t.idle_gaps)
    assert gaps["aten::copy_"] == pytest.approx(0.5)
    assert gaps["host"] == pytest.approx(0.9 + 1.2)
    assert devtrace.summarize(recs, "elsewhere").busy_s == 0.0
