"""In-process user-script runner with stdout capture (port of
``safeincave_tpu/app/script_runner.py``).

The reference's app/script_runner.py:9-110 - the GUI's "script" tab
executes arbitrary user Python in-process, streaming stdout (and
collecting matplotlib figures) into the console widget.  Headless port:
``run_script`` executes a file (or source string) in a fresh namespace,
tees stdout/stderr to an optional callback, and returns the captured text +
namespace, so notebook-style post-processing scripts from reference
workflows keep working.
"""
from __future__ import annotations

import io
import os
import sys
import traceback


class _Tee(io.TextIOBase):
    def __init__(self, *sinks):
        self.sinks = sinks

    def write(self, s):
        for sink in self.sinks:
            sink(s)
        return len(s)

    def flush(self):
        pass


def run_script(path_or_source: str, output_callback=None, echo=False,
               argv=None):
    """Execute a user script; returns (ok, captured_output, namespace)."""
    if os.path.isfile(path_or_source):
        with open(path_or_source) as f:
            source = f.read()
        fname = path_or_source
    else:
        source = path_or_source
        fname = "<script>"

    buf = io.StringIO()
    sinks = [buf.write]
    if output_callback:
        sinks.append(lambda s: output_callback(s))
    if echo:
        sinks.append(sys.__stdout__.write)
    tee = _Tee(*sinks)

    ns = {"__name__": "__main__", "__file__": fname}
    old_out, old_err = sys.stdout, sys.stderr
    old_argv = sys.argv
    sys.stdout = sys.stderr = tee
    if argv is not None:
        sys.argv = [fname] + list(argv)
    ok = True
    try:
        code = compile(source, fname, "exec")
        exec(code, ns)
    except Exception:
        ok = False
        tee.write(traceback.format_exc())
    finally:
        sys.stdout, sys.stderr = old_out, old_err
        sys.argv = old_argv
    return ok, buf.getvalue(), ns
