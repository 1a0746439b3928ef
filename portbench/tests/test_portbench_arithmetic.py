"""The roofline's byte count and the idle-share arithmetic against
counts by hand."""
import pytest

from portbench import generators, trace


def test_floor_bytes_by_hand():
    # poisson2d(3): 9 rows, 4 corners of 3 entries, 4 edges of 4, the
    # centre 5: 33 values; x and y 9 words each
    a = generators.poisson2d(3)
    assert a.nnz == 4 * 3 + 4 * 4 + 5 == 33
    assert trace.spmv_floor_bytes(a.nnz, 9, 4) == 33 * 4 + 2 * 9 * 4 == 204
    assert trace.spmv_floor_bytes(a.nnz, 9, 8) == 408


def test_floor_at_poisson2000():
    # 5 n - 4 N values at N = 2000: 19,992,000; 112 MB; 0.0334 ms
    nnz = 5 * 2000 ** 2 - 4 * 2000
    b = trace.spmv_floor_bytes(nnz, 2000 ** 2, 4)
    assert b == 111_968_000
    assert b / trace.H100_PEAK_BYTES_S * 1e3 == pytest.approx(0.033423,
                                                              rel=1e-4)


def test_roofline_share():
    # the floor's own time reads 100 %, twice it 50 %
    t = 204 / trace.H100_PEAK_BYTES_S
    assert trace.roofline_share(204, t) == pytest.approx(100.0)
    assert trace.roofline_share(204, 2 * t) == pytest.approx(50.0)


def test_busy_union_by_hand():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.75), (6.0, 6.5)]
    # [0, 2] + [3, 4] + [6, 6.5] = 3.5
    assert trace.busy_seconds(iv) == pytest.approx(3.5)
    assert trace.busy_seconds(list(reversed(iv))) == pytest.approx(3.5)
    assert trace.idle_gaps(iv) == [(2.0, 3.0), (4.0, 6.0)]
    assert trace.busy_seconds([]) == 0.0


def test_device_idle_reader():
    from portbench.harness import reader
    read = reader("device_idle.solve")

    class Run:
        # the transport's kernels are busy but leave the share alone
        profile = dict(window_s=4.0, busy_s=2.5, compute_busy_s=1.0,
                       kernels=10)
    assert read(Run()) == pytest.approx(75.0)
    Run.profile = dict(window_s=4.0, busy_s=2.5, compute_busy_s=0.0,
                       kernels=3)
    assert read(Run()) is None
    Run.profile = None
    assert read(Run()) is None


def test_transport_left_out_of_compute_busy_by_hand():
    names = ["hyb_spmv_kernel<float,4,10>",
             "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
             "ncclDevKernel_AllReduce_Sum_f32_RING_LL(...)",
             "void at::native::vectorized_elementwise_kernel<4>"]
    iv = [(0.0, 1.0), (0.5, 3.0), (4.0, 5.0), (4.5, 4.75)]
    # all: [0, 3] + [4, 5] = 4; without NCCL: [0, 1] + [4.5, 4.75] = 1.25
    assert trace.busy_split(names, iv) == pytest.approx((4.0, 1.25))
    assert [trace.is_transport(n) for n in names] == [False, True, True,
                                                     False]
