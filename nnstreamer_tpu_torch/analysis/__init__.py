"""Static analysis of the port's pipelines (nns-lint, nns-xray, nns-san's
static passes, nns-kscope): pre-flight validation of launch strings and
constructed Pipelines without ever starting them.

Public surface, as the reference's ``nnstreamer_tpu.analysis``:

    from nnstreamer_tpu_torch.analysis import lint
    result = lint("videotestsrc ! tensor_converter ! tensor_sink", device="cpu")
    for d in result.diagnostics:
        print(d)            # NNS-E003 error [tensor_filter0]: ...
    sys.exit(result.exit_code)   # 0 clean / 1 warnings / 2 errors

The analyzers negotiate on the pipeline's device, ``cuda`` unless the
caller asks for the CPU. The diagnostic catalog is
:data:`~nnstreamer_tpu_torch.analysis.diagnostics.CATALOG` (listed in the
README's "PyTorch/CUDA port" section).
"""

from nnstreamer_tpu_torch.analysis.diagnostics import (  # noqa: F401
    CATALOG,
    Diagnostic,
    LintReport,
    Severity,
)
from nnstreamer_tpu_torch.analysis.lint import (  # noqa: F401
    DEADLOCK_CODES,
    LintResult,
    annotated_dot,
    check_properties,
    coerce_property,
    lint,
)
from nnstreamer_tpu_torch.analysis.racecheck import run_race_lint  # noqa: F401
from nnstreamer_tpu_torch.analysis.xray import (  # noqa: F401
    XrayResult,
    dispatch_table,
    xray,
)
