"""``docs/api_torch/`` is what ``tools/gen_api_docs_torch.py`` writes from
the port's docstrings today: each committed page equal to the generator's,
and no page missing or left over. A page that fails here is stale:
rewrite the set with ``python tools/gen_api_docs_torch.py``."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = os.path.join(ROOT, "docs", "api_torch")
PAGES = sorted(os.listdir(DOCS))


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    out = tmp_path_factory.mktemp("api_torch")
    subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                 "gen_api_docs_torch.py"),
                    "--out", str(out)], check=True, cwd=ROOT,
                   capture_output=True, timeout=300)
    return str(out)


def test_api_pages_are_the_generators(generated):
    assert sorted(os.listdir(generated)) == PAGES


@pytest.mark.parametrize("page", PAGES)
def test_api_page_is_current(generated, page):
    with open(os.path.join(DOCS, page)) as f:
        committed = f.read()
    with open(os.path.join(generated, page)) as f:
        assert f.read() == committed, (
            f"docs/api_torch/{page} is stale: run python "
            "tools/gen_api_docs_torch.py")
