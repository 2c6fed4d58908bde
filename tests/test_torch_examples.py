"""The port's examples against the JAX package's, on the CPU: each pair runs
in this process on the same seeds, and what they print is compared with
times and temporary paths masked (``examples/torch_*.py`` against
``examples/*.py``)."""
import importlib.util
import itertools
import re
import sys
import tempfile
from pathlib import Path

import pytest

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _outputs(monkeypatch, capsys, tmp_path, name: str) -> tuple[str, str]:
    """(the JAX example's output, the port's with ``--device cpu``); every
    catalog the examples make goes under ``tmp_path``."""
    counter = itertools.count()
    monkeypatch.setattr(tempfile, "mkdtemp",
                        lambda prefix="": str(_fresh(tmp_path / f"{prefix}{next(counter)}")))
    monkeypatch.setattr(sys, "argv", [f"{name}.py"])
    _load(name).main()
    want = capsys.readouterr().out
    _load(f"torch_{name}").main(["--device", "cpu"])
    return want, capsys.readouterr().out


def _fresh(path: Path) -> Path:
    path.mkdir(parents=True)
    return path


def _masked(out: str) -> str:
    out = re.sub(r"@ \S+", "@ <root>", out)
    return re.sub(r"[0-9.]+ms", "<t>ms", out)


@pytest.mark.parametrize("name", ["quickstart", "discover_augment", "service_quickstart"])
def test_example_prints_what_the_jax_example_prints(monkeypatch, capsys, tmp_path, name):
    want, got = _outputs(monkeypatch, capsys, tmp_path, name)
    assert "score" in got or "q=" in got or "+=" in got
    assert _masked(got) == _masked(want)


def _follower_result(out: str, root: Path):
    """The follower's matches as {commit rank of the matched column among
    the catalog's columns of that name kind: score}, and its final column
    count. Every writer's id column holds the same values, so the matches
    are exact ties and the lowest column ids win: which tables those are
    depends on the order the racing writers committed in, read back from
    the run's catalog."""
    from repro_torch.service import CatalogStore
    names = CatalogStore(str(root), device="cpu").snapshot().names
    matches = {}
    for m in re.finditer(r"^  (\S+)\.(\S+)  q=([0-9.]+)$", out, re.MULTILINE):
        column = m.group(2)
        kind = [n for n in names if n.rsplit("_", 1)[-1] == column.rsplit("_", 1)[-1]]
        matches[kind.index(column)] = float(m.group(3))
    n_columns = int(re.search(r"caught up to version \d+: (\d+) columns", out).group(1))
    return matches, n_columns


def test_follower_example_matches_the_jax_example(monkeypatch, capsys, tmp_path):
    """The two writers race, so table order, versions, segments and CAS
    retries differ from run to run in either package (a run under load can
    commit one writer's first two tables before the other's first): the
    matches are compared by the commit rank of their columns, their scores
    within 2e-3, and the final column count."""
    outs = _outputs(monkeypatch, capsys, tmp_path, "follower_quickstart")
    roots = sorted(tmp_path.glob("freyja_follow_*"), key=lambda p: int(p.name.rsplit("_", 1)[1]))
    want, got = (_follower_result(out, root) for out, root in zip(outs, roots))
    assert len(got[0]) == 3 and got[1] == want[1] == 14
    assert set(got[0]) == set(want[0])
    for rank, score in got[0].items():
        assert score == pytest.approx(want[0][rank], abs=2e-3)
