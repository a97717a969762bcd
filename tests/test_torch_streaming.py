"""The port's streaming partition ingest (`repro_torch/core/partition/
streaming.py`), after `test_streaming_partition.py`: the two-pass chunked
builder array for array against `repro`'s builder on the same stream and
against the port's in-memory `EdgeCutLayout`, at k in {1, 4}, on an SBM and
a power-law graph, at chunks 7, 64 and 10**6; its peak transient bytes set
by the chunk, not by |E|; ELL slots filled in stream order; the input
guards.  Host numpy only, no device."""
import dataclasses

import numpy as np
import pytest

from repro.core.graph import powerlaw_graph as jpowerlaw_graph
from repro.core.graph import sbm_graph as jsbm_graph
from repro.core.partition.streaming import GraphEdgeChunks as JGraphEdgeChunks
from repro.core.partition.streaming import (
    build_streaming_layout as jbuild_streaming_layout,
)
from repro_torch.core.engine import EngineConfig
from repro_torch.core.graph import er_graph, from_edges, powerlaw_graph, sbm_graph
from repro_torch.core.partition.edge_cut import hash_partition
from repro_torch.core.partition.layout_api import EdgeCutLayout
from repro_torch.core.partition.streaming import (
    GraphEdgeChunks,
    StreamingLayout,
    build_streaming_layout,
)

SBM = dict(num_vertices=96, num_blocks=8, p_in=0.08, p_out=0.01, seed=0)
POWERLAW = dict(num_vertices=128, avg_degree=6, seed=1)
GRAPHS = {"sbm": (sbm_graph, jsbm_graph, SBM),
          "powerlaw": (powerlaw_graph, jpowerlaw_graph, POWERLAW)}
CHUNKS = (7, 64, 10 ** 6)


def _build(builder, chunks_cls, g, chunk, assignment, k):
    return builder(chunks_cls(g, chunk), assignment, k, g.num_vertices,
                   features=g.features, labels=g.labels,
                   train_mask=g.train_mask, test_mask=g.test_mask)


@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_streaming_layout_matches_the_reference_and_the_in_memory_layout(
        gname, k, chunk):
    make, jmake, kw = GRAPHS[gname]
    g, jg = make(**kw), jmake(**kw)
    # the in-memory layout's own partition (broadcast: no exchange plan to
    # build beyond the global ids)
    lay = EdgeCutLayout(g, k, EngineConfig(execution="broadcast",
                                           partitioner="hash"))
    assignment = lay.part.assignment
    ours = _build(build_streaming_layout, GraphEdgeChunks, g, chunk,
                  assignment, k)
    theirs = _build(jbuild_streaming_layout, JGraphEdgeChunks, jg, chunk,
                    assignment, k)
    for f in dataclasses.fields(StreamingLayout):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    assert (ours.nb, ours.Vp, ours.K) == (lay.nb, lay.Vp, lay.K)
    np.testing.assert_array_equal(ours.new_of_old, lay.new_of_old)
    np.testing.assert_array_equal(ours.ids, lay.ids_global)
    np.testing.assert_array_equal(ours.mask, lay.mask)
    np.testing.assert_array_equal(ours.deg, lay.deg)
    np.testing.assert_array_equal(ours.X.reshape(lay.Vp, -1),
                                  lay.store.flat())
    np.testing.assert_array_equal(ours.y, lay.y)
    np.testing.assert_array_equal(ours.train_w, lay.train_w)
    np.testing.assert_array_equal(ours.test_w, lay.test_w)
    np.testing.assert_array_equal(ours.emb_touched, lay.emb_touched)
    np.testing.assert_array_equal(ours.bmask, lay.bmask)
    assert (ours.bmask.any()) == (k > 1)


def test_peak_memory_bounded_by_chunk_not_graph():
    """4x the edges at the same chunk: the same peak transient bytes; four
    times the chunk: more than twice the peak; the persistent layout is
    reported apart and outweighs it."""
    def build(g, chunk):
        assignment = hash_partition(g, 4).assignment
        return _build(build_streaming_layout, GraphEdgeChunks, g, chunk,
                      assignment, 4)

    g_small = er_graph(256, avg_degree=4, seed=0)
    g_big = er_graph(1024, avg_degree=4, seed=1)
    assert g_big.num_edges > 3 * g_small.num_edges
    lay_s, lay_b = build(g_small, 128), build(g_big, 128)
    assert lay_b.peak_transient_bytes == lay_s.peak_transient_bytes
    lay_b2 = build(g_big, 512)
    assert lay_b2.peak_transient_bytes > 2 * lay_b.peak_transient_bytes
    assert lay_b.layout_bytes > lay_b.peak_transient_bytes
    # one whole-graph chunk holds every edge's transients at once
    whole = build(g_big, g_big.num_edges)
    assert whole.peak_transient_bytes > 4 * lay_b2.peak_transient_bytes


def test_stream_order_defines_slots_and_validation():
    """ELL slots fill in stream order per destination at every chunking;
    the boundary marks a source read across parts; bad inputs raise."""
    src = np.array([2, 0, 1, 0], np.int64)
    dst = np.array([3, 3, 3, 1], np.int64)
    g = from_edges(src, dst, 4)
    assign = np.array([0, 0, 1, 1], np.int32)
    for chunk in (1, 2, 10):
        lay = build_streaming_layout(
            GraphEdgeChunks(g, chunk), assign, 2, 4,
            features=np.zeros((4, 2), np.float32),
            labels=np.zeros(4, np.int32))
        row = lay.ids[lay.new_of_old[3]]
        np.testing.assert_array_equal(
            row[:3], lay.new_of_old[np.array([2, 0, 1])])
        assert lay.bmask[lay.new_of_old[0]]  # 0 (part 0) feeds 3 (part 1)
        assert not lay.bmask[lay.new_of_old[2]]  # 2 -> 3 stays on part 1
    with pytest.raises(ValueError, match="chunk_edges"):
        GraphEdgeChunks(g, 0)
    with pytest.raises(ValueError, match="assignment"):
        build_streaming_layout(GraphEdgeChunks(g, 2), assign[:2], 2, 4,
                               features=np.zeros((4, 2), np.float32),
                               labels=np.zeros(4, np.int32))
