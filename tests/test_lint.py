"""Static gates: every source must byte-compile, and no module may use a
name it never binds anywhere (a class of bug that once shipped: `os.environ`
in models/aln.py with every import spelled `import os as _os` — a NameError
reachable only on the device path with a big genome).

The undefined-name check is deliberately conservative — a name counts as
"bound" if ANY scope in the module binds it — so it cannot false-positive
on cross-function locals, but it catches module-wide never-bound names.
"""

import ast
import builtins
import compileall
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOURCES = []
for root in ("nabwa_tpu", "tests", "scripts"):
    for dirpath, _dirs, files in os.walk(os.path.join(REPO, root)):
        SOURCES.extend(os.path.join(dirpath, f)
                       for f in files if f.endswith(".py"))
for f in ("bench.py", "__graft_entry__.py", "chip_smoke.py"):
    p = os.path.join(REPO, f)
    if os.path.exists(p):
        SOURCES.append(p)

ALLOWED = set(dir(builtins)) | {
    "__file__", "__name__", "__doc__", "__package__", "__spec__",
    "__loader__", "__builtins__", "__debug__", "__class__", "__path__",
}


def _bound_names(tree):
    bound = set()

    class V(ast.NodeVisitor):
        def visit_Name(self, node):
            if isinstance(node.ctx, (ast.Store, ast.Del)):
                bound.add(node.id)
            self.generic_visit(node)

        def visit_FunctionDef(self, node):
            bound.add(node.name)
            a = node.args
            for arg in (a.posonlyargs + a.args + a.kwonlyargs
                        + ([a.vararg] if a.vararg else [])
                        + ([a.kwarg] if a.kwarg else [])):
                bound.add(arg.arg)
            self.generic_visit(node)

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_Lambda(self, node):
            a = node.args
            for arg in (a.posonlyargs + a.args + a.kwonlyargs
                        + ([a.vararg] if a.vararg else [])
                        + ([a.kwarg] if a.kwarg else [])):
                bound.add(arg.arg)
            self.generic_visit(node)

        def visit_ClassDef(self, node):
            bound.add(node.name)
            self.generic_visit(node)

        def visit_Import(self, node):
            for al in node.names:
                bound.add((al.asname or al.name).split(".")[0])

        def visit_ImportFrom(self, node):
            for al in node.names:
                if al.name == "*":
                    continue
                bound.add(al.asname or al.name)

        def visit_ExceptHandler(self, node):
            if node.name:
                bound.add(node.name)
            self.generic_visit(node)

        def visit_Global(self, node):
            bound.update(node.names)

        def visit_Nonlocal(self, node):
            bound.update(node.names)

        def visit_MatchAs(self, node):
            if node.name:
                bound.add(node.name)
            self.generic_visit(node)

        def visit_MatchStar(self, node):
            if node.name:
                bound.add(node.name)
            self.generic_visit(node)

    V().visit(tree)
    return bound


def _star_imports(tree):
    return any(isinstance(n, ast.ImportFrom)
               and any(al.name == "*" for al in n.names)
               for n in ast.walk(tree))


def test_compileall():
    ok = all(compileall.compile_file(p, quiet=2, force=True)
             for p in SOURCES)
    assert ok, "byte-compile failure (see stderr)"


def test_no_never_bound_names():
    problems = []
    for path in SOURCES:
        with open(path, "rb") as fh:
            tree = ast.parse(fh.read(), filename=path)
        if _star_imports(tree):
            continue
        bound = _bound_names(tree) | ALLOWED
        for node in ast.walk(tree):
            if (isinstance(node, ast.Name)
                    and isinstance(node.ctx, ast.Load)
                    and node.id not in bound):
                problems.append(
                    f"{os.path.relpath(path, REPO)}:{node.lineno}: "
                    f"name '{node.id}' is never bound in this module")
    assert not problems, "\n".join(problems)


if __name__ == "__main__":
    test_compileall()
    test_no_never_bound_names()
    print("lint ok:", len(SOURCES), "files")


def test_native_library_builds():
    """The native library must BUILD whenever a compiler exists: a broken
    build silently skips every native-marked test and downgrades the
    engines to Python fallbacks (round-5 incident: a missing include
    made bwasw 500x slower with no failing test)."""
    import shutil
    if shutil.which("g++") is None:
        import pytest
        pytest.skip("no compiler")
    from nabwa_tpu.index import native
    assert native._load() is not None, \
        "native library failed to build (see stderr)"
