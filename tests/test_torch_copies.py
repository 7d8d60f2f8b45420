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
]
# (pattern in the JAX source, the port's text): the only edits outside
# comments and docstrings. The port's binary names its package; the
# spec_divergence help text of the fault kinds drops its tracker tag.
NAMED_EDITS = {
    "client_cli.py": [(r'description="simple_pbft_tpu client"',
                       'description="simple_pbft_tpu_torch client"')],
    "faults.py": [(r'"plane, [A-Z]+ \d+\)"', '"plane)"')],
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
    jax = (ROOT / "simple_pbft_tpu" / rel).read_text()
    for pattern, new in NAMED_EDITS.get(rel, []):
        jax, count = re.subn(pattern, new, jax)
        assert count == 1, (rel, pattern)
    assert _tree((ROOT / "simple_pbft_tpu_torch" / rel).read_text()) == _tree(jax)
