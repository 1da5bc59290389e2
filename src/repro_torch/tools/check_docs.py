"""Docs CI: execute every ``python`` code block of the port's docs and check links.

Documentation rots the moment its snippets stop running. This tool keeps
the port's guide honest:

  * every fenced ```python or ```py block of the given markdown (by default
    the "PyTorch/H100 port" section of ``README.md``) is executed. Blocks of one
    file (or section) run in order in one fresh interpreter (so later blocks
    may use names defined earlier), against a small prelude namespace
    (``np``, ``torch``, ``falcon`` and tiny conforming CPU tensors, see
    ``PRELUDE``). Non-runnable pseudo-code belongs in ```text blocks.
  * every relative markdown link ``[...](path)`` there must resolve to an
    existing file (http(s)/mailto/pure-#anchor links are skipped).

The README's port section tags its blocks ```py: the reference's docs check
(``repro.tools.check_docs``, a JAX prelude) runs only ```python ones. The
prelude's tensors live on the CPU, where every kernel wrapper runs its plain
version: the check needs no card. Run from the repo root::

    PYTHONPATH=src python -m repro_torch.tools.check_docs      # README's port section
    PYTHONPATH=src python -m repro_torch.tools.check_docs docs/x.md --links-only
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile
import textwrap

_FENCE = re.compile(r"^```(\w[\w-]*)?\s*$")
_LINK = re.compile(r"\[[^\]]*\]\(([^)\s]+)\)")

# The default target: this heading's section of README.md.
PORT_SECTION = "## PyTorch/H100 port"

# Names every doc snippet may assume. Kept tiny so the docs job stays fast;
# shapes conform with each other (x @ w, A @ B, attention q/k) and are small
# enough that auto-mode decisions resolve instantly on the CPU.
PRELUDE = """
import numpy as np
import torch
import repro_torch.api as falcon

_rng = np.random.default_rng(0)
A = torch.as_tensor(_rng.standard_normal((64, 48)), dtype=torch.float32)
B = torch.as_tensor(_rng.standard_normal((48, 32)), dtype=torch.float32)
x = torch.as_tensor(_rng.standard_normal((2, 16, 32)), dtype=torch.float32)
w = torch.as_tensor(_rng.standard_normal((32, 64)), dtype=torch.float32)
W = w
q = torch.as_tensor(_rng.standard_normal((2, 16, 4, 8)), dtype=torch.float32)
k = torch.as_tensor(_rng.standard_normal((2, 16, 4, 8)), dtype=torch.float32)
a3 = torch.as_tensor(_rng.standard_normal((4, 16, 32)), dtype=torch.float32)
b3 = torch.as_tensor(_rng.standard_normal((4, 32, 24)), dtype=torch.float32)
batch, prompt_len = 2, 16
a, b = A, B
"""


def section(text: str, heading: str) -> str:
    """The lines of ``text`` from ``heading`` up to the next heading of the
    same level (the whole text where ``heading`` is None)."""
    if heading is None:
        return text
    lines = text.splitlines()
    level = len(heading) - len(heading.lstrip("#"))
    try:
        start = next(i for i, ln in enumerate(lines) if ln.strip() == heading)
    except StopIteration:
        raise ValueError(f"no section {heading!r}") from None
    end, fenced = len(lines), False
    for i in range(start + 1, len(lines)):
        fenced ^= lines[i].strip().startswith("```")      # a code block's "# ..." is no heading
        if not fenced and re.match(rf"^#{{1,{level}}} ", lines[i]):
            end = i
            break
    # keep the line numbers of the file: blank lines stand in for the rest
    return "\n".join([""] * start + lines[start:end])


def extract_python_blocks(text: str) -> list[tuple[int, str]]:
    """-> [(first_line_number, source), ...] for ```python and ```py fences."""
    blocks: list[tuple[int, str]] = []
    in_block = False
    lang = None
    start = 0
    buf: list[str] = []
    for i, line in enumerate(text.splitlines(), 1):
        m = _FENCE.match(line.strip()) if line.strip().startswith("```") else None
        if not in_block and m:
            in_block, lang, start, buf = True, (m.group(1) or ""), i + 1, []
        elif in_block and line.strip() == "```":
            if lang.lower() in ("python", "py"):
                blocks.append((start, "\n".join(buf)))
            in_block = False
        elif in_block:
            buf.append(line)
    return blocks


def run_blocks(path: str, text: str, timeout: int = 600) -> list[str]:
    """Execute ``text``'s python blocks (from ``path``) in one fresh
    interpreter; -> errors."""
    blocks = extract_python_blocks(text)
    if not blocks:
        return []
    # One generated script per file: prelude, then each block exec'd with its
    # doc line number attached so a failure points back into the markdown.
    parts = [PRELUDE, "import traceback as _tb", "_failures = []"]
    for lineno, src in blocks:
        parts.append(
            "try:\n"
            + textwrap.indent(f"exec(compile({src!r}, {f'{path}:{lineno}'!r}, 'exec'))", "    ")
            + "\nexcept Exception:\n"
            f"    _failures.append(({lineno}, _tb.format_exc()))\n")
    parts.append(
        "import sys\n"
        "for _ln, _err in _failures:\n"
        f"    print(f'{path}:{{_ln}}: python block failed\\n{{_err}}')\n"
        "sys.exit(1 if _failures else 0)\n")
    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as tf:
        tf.write("\n".join(parts))
        script = tf.name
    try:
        out = subprocess.run([sys.executable, script], capture_output=True, text=True,
                             timeout=timeout)
        if out.returncode != 0:
            return [f"{path}: {out.stdout.strip() or out.stderr.strip()}"]
        return []
    finally:
        os.unlink(script)


def check_links(path: str, text: str) -> list[str]:
    """Relative markdown links of ``text`` (from ``path``) must resolve to
    existing files."""
    errors = []
    base = os.path.dirname(os.path.abspath(path))
    for target in _LINK.findall(text):
        if target.startswith(("http://", "https://", "mailto:", "#")):
            continue
        rel = target.split("#", 1)[0]
        if rel and not os.path.exists(os.path.join(base, rel)):
            errors.append(f"{path}: broken link -> {target}")
    return errors


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*",
                    help="markdown files, checked whole (default: the "
                         f"{PORT_SECTION!r} section of README.md)")
    ap.add_argument("--links-only", action="store_true",
                    help="skip code-block execution (fast local check)")
    args = ap.parse_args(argv)

    targets = [(p, None) for p in args.paths] or [("README.md", PORT_SECTION)]
    errors: list[str] = []
    for path, heading in targets:
        if not os.path.exists(path):
            errors.append(f"{path}: file not found")
            continue
        with open(path) as f:
            text = section(f.read(), heading)
        link_errs = check_links(path, text)
        errors.extend(link_errs)
        if not args.links_only:
            errs = run_blocks(path, text)
            errors.extend(errs)
            print(f"{path}{f' ({heading.lstrip(chr(35)).strip()})' if heading else ''}: "
                  f"{len(extract_python_blocks(text))} python block(s) "
                  f"{'FAILED' if errs else 'ok'}, links {'broken' if link_errs else 'ok'}")
    if errors:
        print(f"\n{len(errors)} docs problem(s):")
        for e in errors:
            print("  -", e.splitlines()[0])
            if "\n" in e:
                print(textwrap.indent(e, "      "))
        return 1
    print(f"\ndocs ok: {len(targets)} target(s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
