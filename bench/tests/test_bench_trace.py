"""The trace readers: idle gaps by host layer, kernel names, patches."""
import pytest

from bench import trace


def test_gaps_take_the_innermost_open_annotation():
    anns = [(0, 100, "outer"), (10, 20, "inner"), (30, 40, "inner2"),
            (150, 160, "late")]
    gaps = [(12, 18), (22, 28), (31, 33), (90, 120), (200, 210)]
    got = trace.label_gaps(gaps, anns)
    # (90, 120)'s middle is past "outer"
    assert got == pytest.approx({"inner": 6e-9, "outer": 6e-9,
                                 "inner2": 2e-9, trace.OUTSIDE: 40e-9})


def test_kernel_family():
    assert trace.kernel_family(
        "void at::native::vectorized_gather_kernel<16, long>(char*, int)"
    ) == "at::native::vectorized_gather_kernel"
    assert trace.kernel_family(
        "std::enable_if<true, void>::type internal::gemvx::kernel<int, "
        "float>(cublasGemvParamsEx<int>)") == "internal::gemvx::kernel"
    assert trace.kernel_family("Memcpy DtoH (Device -> Pageable)") == \
        "Memcpy DtoH"


def test_patched_restores():
    import repro_torch.core.exec as ex
    real = ex.apply_batch
    with trace.patched({"repro_torch.core.exec:apply_batch":
                        lambda fn: "wrapped"}):
        assert ex.apply_batch == "wrapped"
    assert ex.apply_batch is real
    with pytest.raises(AttributeError):
        trace.resolve("repro_torch.core.exec:no_such_layer")
