"""Structured diagnostics of the port's analyzers (the reference's
gst-validate report model: one registry of finding types, many reports per run,
never fail-fast).

The counterpart of ``nnstreamer_tpu/analysis/diagnostics.py``. Every
problem ``nns-lint``, ``nns-xray``, ``nns-kscope`` and ``nns-san`` can find
has a stable code in the ``NNS-Exxx`` (error) / ``NNS-Wxxx`` (warning) /
``NNS-Rxxx`` (race lint) / ``NNS-Sxxx`` (runtime sanitizer) namespace, so
scripts match on codes instead of message text. The catalog lists only the
codes the port can emit; a code whose meaning differs on the card keeps
its number and takes the port's meaning:

- NNS-W121 / W122 / W124 read the port's programs (a CUDA graph a key, a
  fake-tensor trace, the traced transient bytes) where the reference reads
  jaxprs;
- NNS-W123 (donation) is void and not in the catalog: a CUDA graph copies
  its inputs into its own buffers, so nothing is donated;
- NNS-W127 / W128 / W129 are the Hopper launch analyzer's
  (analysis/kernels.py): a launch the card cannot run, a plan hazard, and
  a kernel request that would raise on the card.

The README's "PyTorch/CUDA port" section lists the catalog; the
self-checks (analysis/selfcheck.py) hold the two together.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class Severity(enum.Enum):
    ERROR = "error"
    WARNING = "warning"

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


# code → (severity, slug, one-line description)
CATALOG: Dict[str, Tuple[Severity, str, str]] = {
    "NNS-E001": (
        Severity.ERROR, "unlinked-sink-pad",
        "an element's required sink pad has nothing linked to it",
    ),
    "NNS-E002": (
        Severity.ERROR, "cycle",
        "the pipeline graph contains a cycle (use tensor_repo for loops)",
    ),
    "NNS-E003": (
        Severity.ERROR, "caps-mismatch",
        "spec negotiation would fail on this element at build time",
    ),
    "NNS-E004": (
        Severity.ERROR, "unknown-element",
        "no element factory registered under this name",
    ),
    "NNS-E005": (
        Severity.ERROR, "bad-property-value",
        "a property value cannot be coerced to its declared type",
    ),
    "NNS-E006": (
        Severity.ERROR, "unknown-framework",
        "tensor_filter framework= names no registered backend",
    ),
    "NNS-E007": (
        Severity.ERROR, "unknown-decoder",
        "tensor_decoder mode= names no registered decoder subplugin",
    ),
    "NNS-E008": (
        Severity.ERROR, "unknown-converter",
        "tensor_converter mode= names no registered converter subplugin",
    ),
    "NNS-E009": (
        Severity.ERROR, "parse-error",
        "the launch string does not parse (bad token, dangling '!', ...)",
    ),
    "NNS-E010": (
        Severity.ERROR, "restricted-element",
        "the element exists but is blocked by [common] restricted_elements",
    ),
    "NNS-E011": (
        Severity.ERROR, "construction-failed",
        "the element constructor raised (missing required property, "
        "unopenable resource, ...)",
    ),
    "NNS-W101": (
        Severity.WARNING, "unknown-property",
        "property is not in the element's schema (typo?)",
    ),
    "NNS-W102": (
        Severity.WARNING, "missing-model-file",
        "tensor_filter model path does not exist on disk",
    ),
    "NNS-W103": (
        Severity.WARNING, "unqueued-tee-branch",
        "mux fan-in branches share a tee ancestor without an intervening "
        "queue (classic deadlock topology)",
    ),
    "NNS-W104": (
        Severity.WARNING, "unreachable-element",
        "element is not reachable from any source; it will never see data",
    ),
    "NNS-W105": (
        Severity.WARNING, "unlinked-src-pad",
        "an element's src pad has nothing linked; its output is dropped",
    ),
    "NNS-W106": (
        Severity.WARNING, "suspicious-property-value",
        "the value parses at runtime but probably not as intended "
        "(e.g. an unrecognized boolean string silently becomes false)",
    ),
    "NNS-W107": (
        Severity.WARNING, "unrouted-error-pad",
        "on-error=route but the dead-letter error pad is unlinked; "
        "failed frames are silently dropped",
    ),
    # -- nns-san graph-level deadlock/capacity pass (analysis/lint.py) ------
    "NNS-W108": (
        Severity.WARNING, "channel-capacity",
        "a bounded channel is sized so it cannot do its job (non-positive "
        "queue-size is clamped to 1; max-batch larger than the input "
        "channel depth can never fill a batch)",
    ),
    "NNS-W109": (
        Severity.WARNING, "unqueued-fanout-join",
        "fan-in branches share a non-tee fan-out ancestor (demux/split) "
        "with no intervening queue on some branch — the same blocking "
        "topology as the tee case (NNS-W103)",
    ),
    "NNS-W110": (
        Severity.WARNING, "rate-skewed-join",
        "a synchronizing fan-in has a data-dependent frame dropper "
        "(tensor_if SKIP, on-error=drop/retry) on a strict subset of its "
        "branches; the join can starve waiting for skipped counterparts",
    ),
    "NNS-W111": (
        Severity.WARNING, "unbounded-query-server",
        "a tensor_query_serversrc has no admission bound (max-clients / "
        "max-inflight / per-client-inflight / rate); overload degrades "
        "as unbounded queueing and silent latency collapse",
    ),
    "NNS-W112": (
        Severity.WARNING, "replica-no-failover-policy",
        "a multi-replica filter (replicas=N) keeps the default "
        "on-error=stop: losing every replica then kills the whole "
        "pipeline, and in a serving pipeline admitted clients hang "
        "instead of receiving terminal NACKs",
    ),
    "NNS-W113": (
        Severity.WARNING, "host-split-device-segments",
        "a host-bound element sits between two device-capable "
        "(traceable) filters: every frame materializes to host and "
        "back mid-stream, defeating the resident device-to-device "
        "segment handoff",
    ),
    "NNS-W114": (
        Severity.WARNING, "duplicate-model-no-sharing",
        "two or more tensor_filter instances open the same "
        "model/framework without shared-tensor-filter-key or a serving "
        "plane: each loads its own copy of the weights on device",
    ),
    "NNS-W115": (
        Severity.WARNING, "oversized-static-kv-cache",
        "an LLM serving element's slot-layout KV cache (n-slots × "
        "max-len, sized for the worst case of every slot) exceeds the "
        "declared device memory bound while kv-layout=paged is "
        "available: a block-table arena serves the same requests in "
        "the actually-used tokens, with prefix sharing on top",
    ),
    "NNS-W116": (
        Severity.WARNING, "host-postproc-splits-device-chain",
        "a tensor_decoder whose decode math HAS a device (traceable) "
        "path runs as a host node between two device-capable filters: "
        "every frame materializes its (usually much larger) decoder "
        "inputs to host mid-stream; postproc=device folds the decode "
        "into the adjacent fused segment and only the small decoded "
        "tensor ever leaves the device",
    ),
    "NNS-W118": (
        Severity.WARNING, "blocking-plane-submit-under-ring",
        "a serving-plane stream that cannot overlap its submits: either "
        "a plane filter sets ring-depth>1 but disables the local window "
        "collector (batching=false forces per-frame blocking submits, "
        "so the in-flight ring never engages), or several streams share "
        "one plane with every in-flight depth left at 1 — each stream "
        "then blocks a full plane round trip per window while the "
        "async ticket ring would overlap submit/compute/delivery",
    ),
    "NNS-W119": (
        Severity.WARNING, "single-endpoint-no-failover",
        "a tensor_query_client stamps a per-request SLO (deadline-ms) "
        "but binds exactly one endpoint with retry-max=0: any endpoint "
        "hiccup is a terminal error with no reconnect, no failover, and "
        "no hedge — bind a fleet (hosts=h1:p1,h2:p2) or grant a "
        "retry-max budget",
    ),
    "NNS-W117": (
        Severity.WARNING, "paged-gather-materializes-cache",
        "a paged LLM serving element is pinned to kv-attn=gather, whose "
        "step programs materialize the full contiguous per-slot view "
        "beside the block arena (a transient HBM doubling) and the "
        "combined footprint exceeds the declared memory bound; the "
        "block-native default (kv-attn=auto/block) attends the arena "
        "directly through the block tables with no gathered view",
    ),
    # -- nns-xray chain analysis (analysis/xray.py) --------------------------
    "NNS-W120": (
        Severity.WARNING, "chain-split-by-host-node",
        "a host-path tensor op severs an otherwise compileable chain "
        "of fused segments: frames materialize to host and re-stage to "
        "device at the split, and the span can never become one "
        "resident program; a device-capable framework (or "
        "postproc=device for decoders, which W116 pinpoints) rejoins "
        "the chain",
    ),
    "NNS-W121": (
        Severity.WARNING, "recompile-hazard-cache-keys",
        "a fused segment's program-cache key space is unbounded or "
        "explodes: a flexible (per-frame shape) input spec under "
        "micro-batching, or signatures x buckets over the bound — each "
        "new key is a fresh CUDA graph capture on the hot path",
    ),
    "NNS-W122": (
        Severity.WARNING, "dtype-promotion-in-device-segment",
        "a device segment's traced program (a fake-tensor trace, nothing "
        "allocated) silently promotes to float64/complex128, or drifts "
        "from its negotiated output dtype, with no 64-bit input: on the "
        "card 64-bit math runs at a fraction of the float32 rate and "
        "doubles activation bytes the specs never declared",
    ),
    # NNS-W123 (donation-defeating-output) is void in the port: nothing is
    # donated (pipeline/transfer.py), so the code is not in the catalog
    "NNS-W124": (
        Severity.WARNING, "chain-transient-hbm-over-bound",
        "a chain's static cost (resident params + peak per-program "
        "transient working set from its traced ops, at the max "
        "micro-batch bucket) exceeds the declared [plane] "
        "memory_per_device bound: the chain runs out of device memory "
        "even though each stage fits alone",
    ),
    "NNS-W125": (
        Severity.WARNING, "chain-eligible-not-compiled",
        "a hazard-free multi-segment chain is running with chain_mode="
        "off: every frame still crosses one service thread per node "
        "where ONE whole-chain program (a CUDA graph replayed once per "
        "window of frames) would serve it — host-dispatch overhead the "
        "compiled-chain path exists to remove",
    ),
    # -- fleet serving robustness -------------------------------------------
    "NNS-W126": (
        Severity.WARNING, "llm-drain-loses-generations",
        "a fleet-tuned query serversrc (explicit retry-after-ms — its "
        "clients re-route on drain NACKs) feeds an LLM serversink with "
        "no migrate-to peer and no checkpoint-dir: draining this "
        "server abandons every in-flight generation's KV and decoded "
        "tokens, so re-routed requests pay a full re-prefill from "
        "token zero on the next endpoint",
    ),
    # -- nns-kscope: the Hopper launch analyzer (analysis/kernels.py) ------
    "NNS-W127": (
        Severity.WARNING, "kernel-launch-exceeds-card",
        "a hand-written kernel's launch cannot run on the card: dynamic "
        "shared memory above 232448 B a block, registers x threads above "
        "65536, more than 1024 threads a block, gridDim.y or gridDim.z "
        "above 65535, or no block resident on an SM",
    ),
    "NNS-W128": (
        Severity.WARNING, "kernel-plan-hazard",
        "a kernel's launch plan breaks what the kernel assumes: an "
        "operand whose alignment or size breaks a vector load (16-byte "
        "cp.async rows, float4 boxes), or a head dim the kernel refuses",
    ),
    "NNS-W129": (
        Severity.WARNING, "kernel-request-raises-on-card",
        "an element explicitly requests a hand-written kernel "
        "(impl=pallas / attn-impl=pallas) that would raise on the card: "
        "the configured mode has no kernel, or the dtype or head dim is "
        "one the kernel refuses",
    ),
    "NNS-W130": (
        Severity.WARNING, "prefill-role-no-decode-peer",
        "an LLM serversink declares role=prefill but names no "
        "decode-peers: every request it prefills decodes locally — the "
        "disaggregation it was configured for never happens, and with "
        "no checkpoint-dir either, a drain abandons the in-flight "
        "generations it was supposed to hand off",
    ),
    # -- nns-san race lint (analysis/racecheck.py): findings over SOURCE ----
    # code, not pipelines; `element` carries file:line
    "NNS-R001": (
        Severity.WARNING, "unlocked-shared-write",
        "a shared counter (self.attr += ...) is read-modify-written from "
        "more than one method of a thread-spawning class without the "
        "owning lock held at every site",
    ),
    "NNS-R002": (
        Severity.WARNING, "blocking-call-under-lock",
        "an unbounded blocking call (sleep, join without timeout, bare "
        "wait, recv/accept) runs while a threading lock is held",
    ),
    "NNS-R003": (
        Severity.ERROR, "swallowed-interrupt",
        "a bare except (or except BaseException) that does not re-raise "
        "swallows KeyboardInterrupt/SystemExit",
    ),
    "NNS-R004": (
        Severity.WARNING, "silent-except-in-loop",
        "except Exception with a pass/continue-only body inside a loop: a "
        "service loop that silently eats every failure forever",
    ),
    "NNS-R005": (
        Severity.WARNING, "thread-without-join",
        "a thread is created with no join-or-daemon story (neither "
        "daemon=True nor a reachable .join())",
    ),
    "NNS-R006": (
        Severity.ERROR, "dekker-ordering",
        "a channel class violates the documented _Chan parking discipline "
        "(advertise the waiting flag BEFORE re-checking the deque; check "
        "the peer's flag AFTER the deque op) — a missed-wakeup bug",
    ),
    # -- nns-san runtime sanitizer (pipeline/sanitize.py) -------------------
    "NNS-S001": (
        Severity.ERROR, "spec-violation",
        "a frame on a negotiated static link does not conform to the "
        "pad's TensorsSpec (shape/dtype drift a replayed graph would mask or a "
        "downstream consumer would crash on)",
    ),
    "NNS-S002": (
        Severity.ERROR, "accounting-leak",
        "a node's frame accounting broke at EOS: offered != delivered + "
        "dropped + routed (frames vanished or were duplicated)",
    ),
    "NNS-S003": (
        Severity.WARNING, "lock-order-cycle",
        "watched locks were acquired in cyclic order by different "
        "threads — a latent deadlock",
    ),
    "NNS-S004": (
        Severity.WARNING, "thread-leak",
        "threads were still alive after Executor shutdown joined "
        "everything it started (stragglers listed)",
    ),
}


@dataclass(frozen=True)
class Diagnostic:
    """One finding: stable code + severity + offending element + advice."""

    code: str
    severity: Severity
    element: Optional[str]  # element (instance) name, None = whole pipeline
    message: str
    hint: str = ""

    @property
    def slug(self) -> str:
        return CATALOG[self.code][1] if self.code in CATALOG else ""

    def __str__(self) -> str:
        where = f" [{self.element}]" if self.element else ""
        hint = f" (hint: {self.hint})" if self.hint else ""
        return (
            f"{self.code} {self.severity.value}{where}: {self.message}{hint}"
        )


def make(code: str, element: Optional[str], message: str, hint: str = "") -> Diagnostic:
    """Build a Diagnostic with the catalog's severity for `code`."""
    sev, _, _ = CATALOG[code]
    return Diagnostic(code, sev, element, message, hint)


@dataclass
class LintReport:
    """All diagnostics from one lint run, never fail-fast."""

    diagnostics: List[Diagnostic] = field(default_factory=list)

    def add(self, code: str, element: Optional[str], message: str,
            hint: str = "") -> None:
        self.diagnostics.append(make(code, element, message, hint))

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity is Severity.ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity is Severity.WARNING]

    @property
    def codes(self) -> List[str]:
        return sorted({d.code for d in self.diagnostics})

    @property
    def exit_code(self) -> int:
        """nns-lint / nns-launch --check contract: 0 clean, 1 warnings
        only, 2 any error."""
        if self.errors:
            return 2
        if self.warnings:
            return 1
        return 0

    def by_element(self) -> Dict[Optional[str], List[Diagnostic]]:
        out: Dict[Optional[str], List[Diagnostic]] = {}
        for d in self.diagnostics:
            out.setdefault(d.element, []).append(d)
        return out

    def render(self) -> str:
        if not self.diagnostics:
            return "pipeline is clean"
        lines = [str(d) for d in self.diagnostics]
        lines.append(
            f"{len(self.errors)} error(s), {len(self.warnings)} warning(s)"
        )
        return "\n".join(lines)
