"""The frozen count of the ingest's least bytes and operations."""
from shedbench_tiny import BENCH  # noqa: F401  (puts the harness on the path)

from yardstick import counting, peaks


def test_bytes_at_the_cell_shape_by_hand():
    C, T, N, nc, nb = 64, 8, 720 * 1280, 2, 64
    frames = C * T * N * 3                      # uint8, as handed over
    lane = 2 * C * N * 4                        # background in and out
    small = C * 4 * 2 + nc * nb * 4 + nc * 4    # gains in/out, the model
    outs = C * T * (nc * nb + nc + 2) * 4       # counts, totals, fg, util
    assert counting.ingest_bytes(C, T, N, nc, nb) == frames + lane + small + outs
    assert counting.ingest_bytes(C, T, N, nc, nb, width=1280) == \
        frames + lane + small + outs + C * T * 16
    assert abs(counting.ingest_bytes(C, T, N, nc, nb) - 1.8875e9) < 1e6


def test_float32_frames_cost_four_times_the_bytes():
    a = counting.ingest_bytes(2, 3, 100, 2, 64, frame_bytes=1)
    b = counting.ingest_bytes(2, 3, 100, 2, 64, frame_bytes=4)
    assert b - a == 2 * 3 * 100 * 3 * 3


def test_ops_and_the_bound():
    assert counting.ingest_ops(64, 8, 921600) == 29 * 64 * 8 * 921600
    nb = counting.ingest_bytes(64, 8, 921600, 2, 64)
    s, by = counting.least_seconds(nb, counting.ingest_ops(64, 8, 921600),
                                   peaks.HBM_BYTES_PER_S, peaks.FP32_OPS_PER_S)
    assert by == "bytes" and abs(s - nb / 3.35e12) < 1e-15
    s, by = counting.least_seconds(1, 10**9, 1e12, 1e12)
    assert by == "operations" and s == 1e-3
