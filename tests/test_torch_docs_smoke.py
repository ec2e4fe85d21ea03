"""The port's docs smoke (``repro_torch.analysis.docs_smoke``) against
the reference's ``tools/docs_smoke.py`` (loaded by path): the same
extraction of ``bash`` blocks on the README and on crafted text, and
``--list`` over the README's port section with the API surface check
appended."""

import importlib.util
import os

import pytest

from repro_torch.analysis import docs_smoke

ROOT = os.path.join(os.path.dirname(__file__), "..")
README = os.path.join(ROOT, "README.md")

CRAFTED = """intro
```bash
echo one   # a comment
echo two \\
    --flag \\
    --other
# a whole-line comment
```
```python
print("not bash")
```
```
echo no info string
```
```bash
echo three \\
```
```bash

echo four
```
"""


def reference():
    spec = importlib.util.spec_from_file_location(
        "tools_docs_smoke", os.path.join(ROOT, "tools", "docs_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("which", ["readme", "crafted", "section"])
def test_extraction_equals_reference(which):
    text = {"readme": open(README, encoding="utf-8").read(),
            "crafted": CRAFTED}.get(which)
    if text is None:
        text = docs_smoke.port_section(open(README, encoding="utf-8").read())
    got = docs_smoke.extract_bash_commands(text)
    assert got == reference().extract_bash_commands(text)
    assert got


def test_crafted_commands():
    assert docs_smoke.extract_bash_commands(CRAFTED) == [
        "echo one   # a comment",
        "echo two      --flag      --other",
        "echo three",
        "echo four"]


def test_list_reads_the_port_section(capsys):
    assert docs_smoke.main(["--readme", README, "--list"]) == 0
    lines = capsys.readouterr().out.splitlines()
    text = open(README, encoding="utf-8").read()
    want = docs_smoke.extract_bash_commands(docs_smoke.port_section(text))
    assert [line[5:] for line in lines[:-1]] == want
    assert lines[-1].startswith("RUN  PYTHONPATH=src ")
    assert lines[-1].endswith("-m repro_torch.analysis.api_surface")
    assert all(line.startswith(("RUN  ", "SKIP ")) for line in lines)
    assert any("repro_torch.launch.dryrun" in line for line in lines)
    assert not any("-m repro.launch" in line for line in lines)
    skipped = [line for line in lines if line.startswith("SKIP ")]
    assert skipped and all("pytest" in line for line in skipped)


def test_no_section_fails(tmp_path, capsys):
    other = tmp_path / "README.md"
    other.write_text("# title\n```bash\necho hi\n```\n")
    assert docs_smoke.main(["--readme", str(other), "--list"]) == 1
