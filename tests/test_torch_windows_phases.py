"""tools/windows_build_phases.py times K4 bf16 and K8 bf16 with phases taken
out, from copies of csrc/corr_windows_build.cu with a few lines of the bf16
kernel edited.  Its timings run on the card only; here each edit is held to
a source laid out as the kernel file is (an fp32 kernel, then a bf16 one, or
one template shared by both): it finds its lines in the kernel with the bf16
products only, exactly once, and changes what it says it does.
tools/corr_build_sources.py's variants of K2's bf16-levels kernel are held
to the committed csrc/corr_build.cu: each edits exactly one line of it; and
tools/lookup_sources.py's variants of the bf16 kernels to the committed
csrc/corr_lookup.cu, csrc/corr_windows_lookup.cu, csrc/corr_pmajor_lookup.cu
and csrc/corr_extract_windows.cu."""
import pytest

from droid_slam_reserch_tpu_torch.tools import corr_build_sources as k2_sources
from droid_slam_reserch_tpu_torch.tools import lookup_sources
from droid_slam_reserch_tpu_torch.tools import windows_build_phases as phases

_BODY = """(const {t}* f1, int* bases, Meta m) {{
  extern __shared__ float4 smem4[];
  for (int kc = 0; kc < nk; kc++) {{
      cp_async_commit();
      {guard}
        {product}(acc[0][ni], af[0], bf);
      }}
    }}
    cp_async_wait<0>();
    __syncthreads();
  }}
  const bool first = band == 0, last = band == m.nbands - 1;
      if constexpr (kStoreLevels) {{
        d[i] = lv[i];
      }}
}}
"""
SPLIT = ("namespace {\n"
         + "windows_build_kernel" + _BODY.format(t="float", guard="if (live) {",
                                                 product="mma_tf32")
         + "\nwindows_build_bf16_kernel" + _BODY.format(t="bf16", guard="if (live) {",
                                                        product="mma_bf16")
         + "}  // namespace\n")
SHARED = ("namespace {\n"
          + "windows_build_kernel" + _BODY.format(
              t="Elem", guard="if constexpr (sizeof(Elem) == 2) {\n        if (live) {",
              product="mma_bf16")
          + "}  // namespace\n")


@pytest.mark.parametrize("source", [SPLIT, SHARED], ids=["split", "shared"])
@pytest.mark.parametrize("variant", list(phases.VARIANTS))
def test_each_variant_edits_only_the_bf16_kernel(source, variant):
    text = phases.variant_sources(source, (variant,))[variant]
    i, j = phases.bf16_kernel(source)
    ti = i + (len(phases._FAKE_MMA) if variant == "c" else 0)
    tj = len(text) - (len(source) - j)
    assert text[:ti].replace(phases._FAKE_MMA, "") == source[:i]   # the fp32 kernel as it was
    assert text[tj:] == source[j:]
    body = text[ti:tj]
    returns = body.count("if (m.nbands > 0) {")
    assert body.count("mma_bf16(acc") == (0 if variant == "c" else 1)
    assert ("fake_mma(acc" in body) == (variant == "c")
    assert (phases._FAKE_MMA in text) == (variant == "c")
    assert returns == (0 if variant in "acf" else 1)
    assert ("live && m.nbands < 0" in body) == (variant == "d")
    assert ("(kStoreLevels) if (m.nbands < 0) {" in body) == (variant == "f")
    if variant == "a":
        assert text == source
    if variant == "b":          # the early return sits just before the stores
        head, _, tail = body.partition(phases._STORES)
        assert "return; }" in head.rsplit("\n", 2)[-2] and "kStoreLevels" in tail
    if variant in "de":         # ... or just after the mainloop
        head, _, tail = body.partition(phases._MAINLOOP_END)
        assert tail.lstrip().startswith("if (m.nbands > 0) {")


def test_an_edit_that_misses_its_line_raises():
    with pytest.raises(ValueError):
        phases.variant_sources(SPLIT.replace(phases._STORES, ""), ("b",))
    with pytest.raises(ValueError):     # no kernel with bf16 products
        phases.variant_sources(SPLIT.replace("mma_bf16", "mma_tf32"), ("a",))


# tools/corr_build_sources.py builds variants of K2's bf16-levels kernel from
# the committed csrc/corr_build.cu: each edit must find its one line there.


@pytest.mark.parametrize("variant", list(k2_sources.VARIANTS))
def test_k2_variant_edits_one_line_of_the_committed_source(variant):
    texts = k2_sources.variant_texts("this", k2_sources.SOURCE)
    assert set(texts) == {"this"} | {f"this-{v}" for v in k2_sources.VARIANTS}
    a, b = texts["this"][0].splitlines(), texts[f"this-{variant}"][0].splitlines()
    assert len(a) == len(b)
    changed = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
    assert len(changed) == 1
    old, new = k2_sources.VARIANTS[variant]
    assert a[changed[0]].strip().endswith(old) and b[changed[0]].strip().endswith(new)


# tools/lookup_sources.py builds variants of the bf16 kernels of K3, K5, K6
# and K7 from the committed csrc/: each variant's edits must find their text
# there once each, and leave the fp32 kernel before it as it is.


@pytest.mark.parametrize("kern,variant", [(k, v) for k, vs in lookup_sources.VARIANTS.items()
                                          for v in vs])
def test_lookup_variant_edits_only_the_bf16_kernel(kern, variant):
    texts = lookup_sources.variant_texts("this", lookup_sources.CSRC)
    assert ({k for kk, k in texts if kk == kern}
            == {"this"} | {f"this-{v}" for v in lookup_sources.VARIANTS[kern]})
    text, edited = texts[kern, "this"][0], texts[kern, f"this-{variant}"][0]
    start = text.index("constexpr int kTileB")        # the bf16 kernel's part of the source
    assert edited[:start] == text[:start] and edited != text
    for old, new in lookup_sources.VARIANTS[kern][variant]:
        assert text.count(old) == 1 and new in edited
