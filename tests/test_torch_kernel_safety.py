"""The port's kernel-safety rules (``predictionio_tpu_torch/analysis/
kernel_safety.py``: ``dma-unwaited``, ``low-precision-accumulator`` and
``missing-interpret-fallback``) held to the JAX package's
(``predictionio_tpu/analysis/kernels.py``).

Each case of the JAX package's ``tests/test_check.py::TestDmaUnwaited``,
``TestLowPrecisionAccumulator`` and ``TestMissingInterpretFallback`` is
here twice: its Pallas source through the JAX package's rule, and the
same fault written in CUDA (or in an ``ops/`` wrapper of the port) in a
scratch package through the port's rule; both must find the same number
of findings. Then each rule's own cases over ``csrc/``: helpers followed
through the call graph, TMA and mbarriers, macro-made exports, the C
pragma, and the port's tree clean with no baseline.
"""

import textwrap
from pathlib import Path

import pytest

import predictionio_tpu.analysis as janalysis
import predictionio_tpu_torch.analysis as panalysis
from predictionio_tpu_torch.analysis import kernel_safety as ks

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "predictionio_tpu_torch"
RULES = ["dma-unwaited", "low-precision-accumulator",
         "missing-interpret-fallback"]

PALLAS_PRELUDE = textwrap.dedent("""\
    import functools
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
""")

#: a wrapper module every scratch package gets: a loader and a launcher
#: that names the exports the C fixtures define
WRAPPER = textwrap.dedent("""\
    import ctypes

    def load_library(name):
        return ctypes.CDLL(name)

    def _kernel_lib():
        return load_library("k")

    def k(x):
        if x.device.type == "cpu":
            return x
        if x.device.type != "cuda":
            raise ValueError(x.device)
        err = _kernel_lib().k_f32(x.data_ptr(), 0)
        if err:
            raise RuntimeError(err)
        return x
""")

EXPORT = textwrap.dedent("""\
    extern "C" int k_f32(const void* x, void* stream) {
      kern<<<1, 32, 0, (cudaStream_t)stream>>>((const float*)x);
      return (int)cudaGetLastError();
    }
""")


def jax_findings(body, rule):
    code = PALLAS_PRELUDE + textwrap.dedent(body)
    return [f for f in janalysis.check_source(code, path="ops/k.py",
                                              rule_names=[rule])
            if f.rule == rule]


def package(tmp_path, cu="", wrapper=WRAPPER, extra=None):
    """A scratch package ``pkg/`` with ``ops/k.py`` and ``csrc/k.cu``
    (the fixture, then the ``k_f32`` export)."""
    pkg = tmp_path / "pkg"
    (pkg / "ops").mkdir(parents=True)
    (pkg / "csrc").mkdir()
    (pkg / "ops" / "k.py").write_text(wrapper)
    (pkg / "csrc" / "k.cu").write_text(textwrap.dedent(cu) + EXPORT)
    for name, text in (extra or {}).items():
        (pkg / "csrc" / name).write_text(textwrap.dedent(text))
    return pkg


def port_findings(pkg, rule):
    return [f for f in panalysis.run_check([str(pkg)], rule_names=[rule])
            if f.rule == rule]


# -- dma-unwaited -------------------------------------------------------------

CP_ASYNC_HELPERS = """
    __device__ __forceinline__ void cp_async16(void* dst, const void* src) {
      const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(d),
                   "l"(src));
    }
    __device__ __forceinline__ void cp_async_commit() {
      asm volatile("cp.async.commit_group;\\n" ::);
    }
    template <int N>
    __device__ __forceinline__ void cp_async_wait() {
      asm volatile("cp.async.wait_group %0;\\n" ::"n"(N));
    }
"""

DMA_CASES = {
    # the JAX case, its Pallas source, the CUDA source, the findings
    "test_start_without_wait": ("""
        def kern(h_ref, o_ref, buf, sem):
            pltpu.make_async_copy(h_ref.at[0], buf.at[0],
                                  sem.at[0]).start()
            o_ref[:] = buf[0]
    """, CP_ASYNC_HELPERS + """
    __global__ void kern(const float* x) {
      __shared__ float4 buf[32];
      cp_async16(&buf[threadIdx.x], x + 4 * threadIdx.x);
      cp_async_commit();
      __syncthreads();
    }
    """, 1),
    "test_var_start_wait_pair_clean": ("""
        def kern(h_ref, o_ref, buf, sem):
            c = pltpu.make_async_copy(h_ref.at[0], buf.at[0], sem.at[0])
            c.start()
            c.wait()
            o_ref[:] = buf[0]
    """, """
    __global__ void kern(const float* x) {
      __shared__ float4 buf[32];
      const unsigned d = static_cast<unsigned>(
          __cvta_generic_to_shared(&buf[threadIdx.x]));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
                   "l"(x));
      asm volatile("cp.async.commit_group;" ::);
      asm volatile("cp.async.wait_all;" ::);
      __syncthreads();
    }
    """, 0),
    # issue in one helper, drain in another: matched through the calls
    "test_split_start_and_wait_matched_by_semaphore": ("""
        def kern(h_ref, o_ref, buf, sems):
            def issue(slot):
                pltpu.make_async_copy(h_ref.at[slot], buf.at[slot],
                                      sems.at[slot]).start()

            def drain(slot):
                pltpu.make_async_copy(h_ref.at[slot], buf.at[slot],
                                      sems.at[slot]).wait()

            issue(0)
            drain(0)
            o_ref[:] = buf[0]
    """, CP_ASYNC_HELPERS + """
    __device__ void issue(float4* buf, const float* x) {
      cp_async16(&buf[threadIdx.x], x + 4 * threadIdx.x);
      cp_async_commit();
    }
    __device__ void drain() { cp_async_wait<0>(); }
    __global__ void kern(const float* x) {
      __shared__ float4 buf[32];
      issue(buf, x);
      drain();
      __syncthreads();
    }
    """, 0),
    # the JAX rule's slot restarted before its wait; in CUDA groups are
    # counted, not named: a copy issued after the last wait is the fault
    "test_slot_restarted_before_wait": ("""
        def kern(h_ref, o_ref, buf, sem):
            pltpu.make_async_copy(h_ref.at[0], buf.at[0],
                                  sem.at[0]).start()
            pltpu.make_async_copy(h_ref.at[1], buf.at[1],
                                  sem.at[0]).start()
            pltpu.make_async_copy(h_ref.at[0], buf.at[0],
                                  sem.at[0]).wait()
            o_ref[:] = buf[0]
    """, CP_ASYNC_HELPERS + """
    __global__ void kern(const float* x) {
      __shared__ float4 buf[64];
      cp_async16(&buf[threadIdx.x], x);
      cp_async_commit();
      cp_async_wait<0>();
      cp_async16(&buf[32 + threadIdx.x], x + 128);
      cp_async_commit();
    }
    """, 1),
}


@pytest.mark.parametrize("case", sorted(DMA_CASES))
def test_dma_unwaited_finds_what_the_jax_rule_finds(case, tmp_path):
    pallas, cuda, n = DMA_CASES[case]
    assert len(jax_findings(pallas, "dma-unwaited")) == n
    found = port_findings(package(tmp_path, cuda), "dma-unwaited")
    assert len(found) == n, [f.format() for f in found]
    for f in found:
        assert "no cp.async.wait_group" in f.message
        assert f.path.endswith("csrc/k.cu")


def test_an_unwaited_issue_is_found_at_its_first_line_through_the_helper(
        tmp_path):
    cu = CP_ASYNC_HELPERS + """
    __global__ void kern(const float* x) {
      __shared__ float4 buf[32];
      cp_async16(&buf[threadIdx.x], x);
      cp_async_commit();
    }
    """
    (f,) = port_findings(package(tmp_path, cu), "dma-unwaited")
    lines = textwrap.dedent(cu).splitlines()
    assert "cp_async16(&buf" in lines[f.line - 1]
    assert "through `cp_async16`" in f.message


@pytest.mark.parametrize("wait,n", [
    ('asm volatile("mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;"'
     ' ::"r"(bar));', 0),
    ("", 1)])
def test_a_tma_copy_needs_its_mbarrier_wait(tmp_path, wait, n):
    cu = f"""
    __global__ void kern(const float* x) {{
      __shared__ float buf[256];
      unsigned bar = 0;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], 1024, [%2];" ::"r"(0), "l"(x), "r"(bar));
      {wait}
    }}
    """
    assert len(port_findings(package(tmp_path, cu), "dma-unwaited")) == n


def test_the_double_buffered_pipeline_is_clean(tmp_path):
    """The port's own idiom (``fused_topk.cu``, ``gram_tile.cuh``): a
    lambda issues chunk c + 1 while chunk c is read, and the last chunk
    waits for everything."""
    cu = CP_ASYNC_HELPERS + """
    __global__ void kern(const float* x, int n) {
      __shared__ float4 buf[2][32];
      auto load = [&](int c) {
        cp_async16(&buf[c & 1][threadIdx.x], x + 128 * c);
        cp_async_commit();
      };
      load(0);
      for (int c = 0; c < n; ++c) {
        if (c + 1 < n) {
          load(c + 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
      }
    }
    """
    assert port_findings(package(tmp_path, cu), "dma-unwaited") == []


def test_a_c_pragma_silences_dma_unwaited(tmp_path):
    cu = CP_ASYNC_HELPERS + """
    __global__ void kern(const float* x) {
      __shared__ float4 buf[32];
      // ptpu: allow[dma-unwaited] — the next launch on the stream waits
      cp_async16(&buf[threadIdx.x], x);
      cp_async_commit();
    }
    """
    assert port_findings(package(tmp_path, cu), "dma-unwaited") == []


# -- low-precision-accumulator ------------------------------------------------

def _bf16_pallas(dtype):
    return f"""
        def kern(x_ref, o_ref, acc):
            acc[:] = acc[:] + x_ref[:]
            o_ref[:] = acc[:]

        def run(x):
            return pl.pallas_call(
                kern,
                in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
                out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
                out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
                scratch_shapes=[pltpu.VMEM((8, 128), jnp.{dtype})],
                interpret=True,
            )(x)
    """


def _bf16_cuda(ctype):
    return f"""
    __global__ void kern(const {ctype}* x, float* out) {{
      __shared__ {ctype} acc[128];
      acc[threadIdx.x] = x[threadIdx.x];
      for (int i = 1; i < 8; ++i)
        acc[threadIdx.x] = acc[threadIdx.x] + x[i * 128 + threadIdx.x];
      out[threadIdx.x] = static_cast<float>(acc[threadIdx.x]);
    }}
    """


ACC_CASES = {
    "test_bf16_accumulation_flagged": (
        _bf16_pallas("bfloat16"), _bf16_cuda("__nv_bfloat16"), 1),
    "test_f32_accumulator_clean": (
        _bf16_pallas("float32"), _bf16_cuda("float"), 0),
    "test_augassign_and_dot_into_bf16": ("""
        def kern(x_ref, o_ref, acc):
            acc[:] += x_ref[:]
            acc[:] = jax.lax.dot_general(
                x_ref[:], x_ref[:], (((0,), (0,)), ((), ())))
            o_ref[:] = acc[:]

        def run(x):
            return pl.pallas_call(
                kern,
                in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
                out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
                out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
                scratch_shapes=[pltpu.VMEM((128, 128), jnp.float16)],
                interpret=True,
            )(x)
    """, """
    __global__ void kern(const __half* x, const unsigned* a,
                         const unsigned* b, float* out) {
      __half acc = __float2half(0.f);
      for (int i = 0; i < 8; ++i) acc += x[i];
      unsigned d[2] = {0u, 0u};
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f16.f16.f16.f16 "
          "{%0, %1}, {%2, %3, %4, %5}, {%6, %7}, {%0, %1};"
          : "+r"(d[0]), "+r"(d[1])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
      out[0] = __half2float(acc) + d[0];
    }
    """, 2),
    # the JAX case binds leading arguments with functools.partial; in
    # CUDA the accumulator reaches a helper as a pointer parameter
    "test_partial_bound_kernel_mapping": ("""
        def kern(n, x_ref, o_ref, acc):
            acc[:] = acc[:] + x_ref[:]
            o_ref[:] = acc[:]

        def run(x):
            k = functools.partial(kern, 4)
            return pl.pallas_call(
                k,
                in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
                out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
                out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
                scratch_shapes=[pltpu.VMEM((8, 128), jnp.bfloat16)],
                interpret=True,
            )(x)
    """, """
    __device__ void add_row(__nv_bfloat16* acc, const __nv_bfloat16* x) {
      acc[threadIdx.x] = __hadd(acc[threadIdx.x], x[threadIdx.x]);
    }
    __global__ void kern(const __nv_bfloat16* x, float* out) {
      __shared__ __nv_bfloat16 acc[128];
      add_row(acc, x);
      out[threadIdx.x] = __bfloat162float(acc[threadIdx.x]);
    }
    """, 1),
}


@pytest.mark.parametrize("case", sorted(ACC_CASES))
def test_low_precision_accumulator_finds_what_the_jax_rule_finds(
        case, tmp_path):
    pallas, cuda, n = ACC_CASES[case]
    assert len(jax_findings(pallas, "low-precision-accumulator")) == n
    found = port_findings(package(tmp_path, cuda),
                          "low-precision-accumulator")
    assert len(found) == n, [f.format() for f in found]


def test_the_bf16_message_names_the_type(tmp_path):
    (f,) = port_findings(package(tmp_path, _bf16_cuda("__nv_bfloat16")),
                         "low-precision-accumulator")
    assert "__nv_bfloat16 `acc`" in f.message


@pytest.mark.parametrize("ptx,n", [
    ("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32", 0),
    ("mma.sync.aligned.m16n8k16.row.col.bf16.bf16.bf16.bf16", 1),
    ("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32", 0),
    ("wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16", 0),
    ("wgmma.mma_async.sync.aligned.m64n128k16.f16.f16.f16", 1)])
def test_a_tensor_core_accumulator_must_be_wide(tmp_path, ptx, n):
    cu = f"""
    __global__ void kern(float* out) {{
      asm volatile("{ptx} {{%0}}, {{%1}}, {{%2}}, {{%0}};" ::);
    }}
    """
    assert len(port_findings(package(tmp_path, cu),
                             "low-precision-accumulator")) == n


def test_a_half_wmma_accumulator_is_found(tmp_path):
    cu = """
    #include <mma.h>
    __global__ void kern(float* out) {
      nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, half> c;
      nvcuda::wmma::fill_fragment(c, 0.f);
    }
    """
    assert len(port_findings(package(tmp_path, cu),
                             "low-precision-accumulator")) == 1


def test_loads_and_conversions_of_bf16_are_not_accumulations(tmp_path):
    cu = """
    __device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                          float (&v)[4]) {
      for (int i = 0; i < 4; ++i) v[i] = __bfloat162float(p[i]);
    }
    __device__ __forceinline__ __nv_bfloat16 zero_of(const __nv_bfloat16*) {
      return __float2bfloat16(0.f);
    }
    __global__ void kern(const __nv_bfloat16* x, __nv_bfloat16* y) {
      float v[4];
      load4(x, v);
      float s = 0.f;
      for (int i = 0; i < 4; ++i) s += v[i];
      y[threadIdx.x] = __float2bfloat16(s);
    }
    """
    assert port_findings(package(tmp_path, cu),
                         "low-precision-accumulator") == []


def test_a_c_pragma_silences_low_precision_accumulator(tmp_path):
    cu = _bf16_cuda("__nv_bfloat16").replace(
        "      for (int i = 1;",
        "      // ptpu: allow[low-precision-accumulator] — a test\n"
        "      for (int i = 1;")
    cu = cu.replace(
        "        acc[threadIdx.x] = acc[threadIdx.x] +",
        "        // ptpu: allow[low-precision-accumulator] — a test\n"
        "        acc[threadIdx.x] = acc[threadIdx.x] +")
    assert port_findings(package(tmp_path, cu),
                         "low-precision-accumulator") == []


# -- missing-interpret-fallback -----------------------------------------------

LAUNCHER = """
    import ctypes

    def load_library(name):
        return ctypes.CDLL(name)

    def _kernel_lib():
        return load_library("k")

    def reference(x):
        return x

    def k(x):
    {body}
        err = _kernel_lib().k_f32(x.data_ptr(), 0)
        if err:
            raise RuntimeError(err)
        return x
"""


def launcher(body):
    body = textwrap.indent(textwrap.dedent(body), "    ")
    return textwrap.dedent(LAUNCHER).replace("{body}\n", body)


MIF_CASES = {
    # a path of the CUDA branch that launches nothing: the JAX case's
    # pallas_call with no interpret= route
    "test_no_interpret_kwarg_flagged": ("""
        def kern(x_ref, o_ref):
            o_ref[:] = x_ref[:]

        def run(x):
            return pl.pallas_call(
                kern,
                in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
                out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
                out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
            )(x)
    """, launcher("""
        if x.device.type == "cpu":
            return reference(x)
        if x.shape[0] < 64:
            return reference(x)
    """), 1),
    "test_interpret_param_clean": ("""
        def kern(x_ref, o_ref):
            o_ref[:] = x_ref[:]

        def run(x, interpret=False):
            return pl.pallas_call(
                kern,
                in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
                out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
                out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
                interpret=interpret,
            )(x)
    """, launcher("""
        if x.device.type == "cpu":
            return reference(x)
        if x.device.type != "cuda":
            raise ValueError(f"k runs on cuda or cpu, got {x.device}")
        if x.shape[0] == 0:
            return x
    """), 0),
    # a literal that pins the route: here a try that falls back
    "test_interpret_false_literal_flagged": ("""
        def kern(x_ref, o_ref):
            o_ref[:] = x_ref[:]

        def run(x):
            return pl.pallas_call(
                kern,
                in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
                out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
                out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
                interpret=False,
            )(x)
    """, launcher("""
        if x.device.type == "cpu":
            return reference(x)
        try:
            lib = _kernel_lib()
        except OSError:
            return reference(x)
    """), 1),
}


@pytest.mark.parametrize("case", sorted(MIF_CASES))
def test_missing_interpret_fallback_finds_what_the_jax_rule_finds(
        case, tmp_path):
    pallas, wrapper, n = MIF_CASES[case]
    assert len(jax_findings(pallas, "missing-interpret-fallback")) == n
    found = port_findings(package(tmp_path, wrapper=wrapper),
                          "missing-interpret-fallback")
    assert len(found) == n, [f.format() for f in found]
    for f in found:
        assert f.path.endswith("ops/k.py")
        assert "reaches neither the kernel nor a refusal" in f.message


def test_non_pallas_module_ignored(tmp_path):
    """The JAX case's module with no kernel: outside ``ops/``, or with
    no loader, nothing is a launcher."""
    assert janalysis.check_source(
        "def pallas_call(x):\n    return x\n", path="ops/k.py",
        rule_names=["missing-interpret-fallback"]) == []
    src = launcher("""
        if x.shape[0] < 64:
            return reference(x)
    """)
    assert panalysis.check_source(
        src, path="pkg/server/k.py",
        rule_names=["missing-interpret-fallback"]) == []
    assert panalysis.check_source(
        src.replace('load_library("k")', 'ctypes.CDLL("k")'),
        path="pkg/ops/k.py",
        rule_names=["missing-interpret-fallback"]) == []


@pytest.mark.parametrize("branch", [
    'if x.device.type != "cpu":\n    return reference(x)',
    'if "cpu" != x.device.type:\n    return reference(x)',
    'if x.device.type == "cpu":\n    pass\nelse:\n    return reference(x)',
    'if route == "plain":\n    return reference(x)',
    'if x.device.type == "cpu" or x.shape[0] < 64:\n'
    '    return reference(x)',
], ids=["not-cpu", "not-cpu-reversed", "else-of-cpu", "plain-route",
        "cpu-or-more"])
def test_a_cuda_branch_that_returns_the_plain_version_is_found(branch):
    """Only the CPU side of a test on ``"cpu"`` may return before the
    launch: a return under ``!= "cpu"``, in the else of ``== "cpu"``,
    under a route a failed build could pick, or under a test that lets
    CUDA tensors in too, is a CUDA fallback."""
    src = launcher(branch + "\n")
    (f,) = panalysis.check_source(
        src, path="pkg/ops/k.py", rule_names=["missing-interpret-fallback"])
    assert "reaches neither the kernel nor a refusal" in f.message


def test_the_else_of_a_not_cpu_test_is_the_cpu_side():
    src = launcher("""
        if x.device.type != "cpu":
            pass
        else:
            return reference(x)
    """)
    assert panalysis.check_source(
        src, path="pkg/ops/k.py",
        rule_names=["missing-interpret-fallback"]) == []


def test_a_python_pragma_silences_the_launcher_finding(tmp_path):
    src = launcher("""
        if x.shape[0] < 64:
            # ptpu: allow[missing-interpret-fallback] — a test
            return reference(x)
    """)
    assert panalysis.check_source(
        src, path="pkg/ops/k.py",
        rule_names=["missing-interpret-fallback"]) == []


def test_an_export_no_wrapper_names_is_found(tmp_path):
    extra = {"more.cu": """
    __global__ void other(float* x) {}
    extern "C" int other_f32(void* x, void* stream) {
      other<<<1, 1, 0, (cudaStream_t)stream>>>((float*)x);
      return 0;
    }
    extern "C" long long other_smem_bytes(int r) { return 4LL * r; }
    """}
    (f,) = port_findings(package(tmp_path, extra=extra),
                         "missing-interpret-fallback")
    assert f.path.endswith("csrc/more.cu") and f.line == 3
    assert "`other_f32`" in f.message


def test_a_macro_made_export_is_read_at_its_use(tmp_path):
    extra = {"macro.cu": """
    #define ENTRY(NAME, T)                                  \\
      extern "C" int NAME(const void* x, void* stream) {    \\
        return 0;                                           \\
      }

    ENTRY(k_f32, float)
    ENTRY(k_bf16, __nv_bfloat16)
    """}
    (f,) = port_findings(package(tmp_path, extra=extra),
                         "missing-interpret-fallback")
    assert "`k_bf16`" in f.message and f.line == 8


def test_the_ports_exports_are_all_found_and_named():
    exports = {name for path in sorted((PORT / "csrc").iterdir())
               for name, _ in ks._exports(ks._CFile(str(path),
                                                    path.read_text()))}
    assert exports == {
        "chol_solve_f32", "fused_gram_f32", "fused_gram_bf16",
        "fused_topk_f32", "fused_topk_bf16", "fused_topk_i8",
        "gram_table_f32", "gram_table_bf16"}


# -- the port's tree ----------------------------------------------------------

@pytest.mark.parametrize("rule", RULES)
def test_the_ports_tree_is_clean(rule):
    assert panalysis.run_check([str(PORT)], rule_names=[rule]) == []


def test_the_rules_read_every_kernel_and_the_pipelines_in_csrc():
    """Every ``__global__`` function of the port's sources is found, and
    the double-buffered gathers (and gram_table's table load) are seen
    to issue and to wait."""
    fns = [fn for path in sorted((PORT / "csrc").iterdir())
           for fn in ks._functions(ks._CFile(str(path), path.read_text()))]
    kernels = {fn.name for fn in fns if fn.kernel}
    assert {"gram_rows_kernel", "fused_topk_kernel", "merge_topk_kernel",
            "gram_table_kernel", "chol_solve_regs",
            "chol_solve_smem"} <= kernels, kernels
    summary, _ = ks._dma_summaries(fns)
    assert summary["cp_async16"] == (True, False)
    assert summary["cp_async_wait"] == (False, True)
    for name in ("gram_row", "fused_topk_kernel", "worker_loop",
                 "gram_table_kernel"):
        assert summary[name] == (False, True), name
