"""The port's verbatim copies of framework-neutral modules stay verbatim.

Each copy may differ from the JAX package's module only in comments,
docstrings and the named edits below, so its syntax tree with docstrings
removed must equal the original's once the named edits are applied to
it. Comments are not in the tree, which leaves the copies free to drop
TPU figures and history.
"""

import ast
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
COPIES = [
    "telemetry.py",
    "audit.py",
    "controller.py",
    "deploy.py",
    "transport/tcp.py",
    "transport/grpc.py",
    "workload.py",
    "faults.py",
    "client_cli.py",
    "sim.py",
    "crypto/costmodel.py",
    "tools/span_ledger.py",
    "tools/critical_path.py",
    "tools/verify_observatory.py",
]
# (pattern in the JAX source, the port's text): the only edits outside
# comments and docstrings. The port's binary names its package; the
# spec_divergence help text of the fault kinds drops its tracker tag; the
# cost model's one peak is the card's memory read rate, measured on the
# card; the report tools import the port's modules and their siblings
# as a package instead of putting the repo's tools/ on sys.path, and the
# observatory keeps its utilization to six places, since the card's
# verify passes read about 1e-4 of its memory rate, and names the five
# limiters of a run with device dispatches as LIMITERS, the one list the
# smoke and the tests check a verdict against.
NAMED_EDITS = {
    "crypto/costmodel.py": [(r'\{"v5lite": 12\.1\}', '{"h100": 2970.6}')],
    "client_cli.py": [(r'description="simple_pbft_tpu client"',
                       'description="simple_pbft_tpu_torch client"')],
    "faults.py": [(r'"plane, [A-Z]+ \d+\)"', '"plane)"')],
    "tools/critical_path.py": [
        (r"import os\n", ""),
        (r"sys\.path\.insert\(0, os\.path\.dirname\(os\.path\.abspath\(__file__\)\)\)\n"
         r"from span_ledger import", "from .span_ledger import"),
    ],
    "tools/verify_observatory.py": [
        (r"(?s)_TOOLS = .*?import load_bench_ledger  # noqa: E402",
         "from ..crypto import costmodel\n"
         "from ..devledger import LANE_SUM_KEYS, TOP_MIRROR_KEYS, lane_view\n"
         "from ..telemetry import load_bench_ledger\n"
         "from . import critical_path"),
        (r"roofline attribution for the TPU verify path",
         "roofline attribution for the GPU verify path"),
        (r"round\(achieved / peak_gather_gbps, 3\)", "round(achieved / peak_gather_gbps, 6)"),
        (r"\n\n\ndef dominant_limiter\(",
         '\n\n\nLIMITERS = ("bandwidth", "dispatch_gap", "host_prep", "queue_starvation", '
         '"host_cpu_path")\n\n\ndef dominant_limiter('),
    ],
}


class _StripDocstrings(ast.NodeTransformer):
    def _strip(self, node):
        self.generic_visit(node)
        body = node.body
        if (body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        return node

    visit_Module = visit_ClassDef = visit_FunctionDef = visit_AsyncFunctionDef = _strip


def _tree(source):
    return ast.dump(_StripDocstrings().visit(ast.parse(source)), include_attributes=False)


@pytest.mark.parametrize("rel", COPIES)
def test_port_copy_equals_the_jax_module_but_for_docstrings(rel):
    # the report tools' originals stand in the repo's tools/, beside the
    # JAX package; every other original is in the package
    jax = (ROOT / ("" if rel.startswith("tools/") else "simple_pbft_tpu") / rel).read_text()
    for pattern, new in NAMED_EDITS.get(rel, []):
        jax, count = re.subn(pattern, new, jax)
        assert count == 1, (rel, pattern)
    assert _tree((ROOT / "simple_pbft_tpu_torch" / rel).read_text()) == _tree(jax)
