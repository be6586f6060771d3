"""The port's ScreenPrinter against the JAX package's: the partition table
of an RCB-partitioned grid and ``start_timer``."""
import time

import pytest

import safeincave_torch as st
import safeincave_tpu as sc
from safeincave_torch.output.screen import ScreenPrinter as PortPrinter
from safeincave_tpu.output.screen import ScreenPrinter as JaxPrinter


def _table(lines):
    """The partition table's lines of a banner."""
    start = next(i for i, ln in enumerate(lines) if "partitions:" in ln)
    end = start + 1
    while end < len(lines) and lines[end].startswith(" " * 15):
        end += 1
    return lines[start:end]


@pytest.mark.parametrize("nparts", [2, 5])
def test_partition_table_matches_jax(nparts, capsys):
    """The banner of a grid loaded with ``nparts`` (RCB) lists each part's
    elements and touched nodes as the JAX package's banner does."""
    tables = []
    for pkg, printer in ((sc, JaxPrinter), (st, PortPrinter)):
        grid = pkg.GridHandlerGMSH("geom", pkg.Utils.find_grid(
            "cavern_proxy_600"), reorder="rcb", nparts=nparts)
        printer.reset_instance()
        tables.append(_table(printer(grid=grid).lines))
        printer.reset_instance()
    assert tables[0] == tables[1]
    assert len(tables[1]) == nparts + 1


def test_no_partition_table_without_parts(capsys):
    PortPrinter.reset_instance()
    lines = PortPrinter(grid=st.GridBox(nx=2, ny=2, nz=2)).lines
    PortPrinter.reset_instance()
    assert not any("partitions:" in ln for ln in lines)


def test_start_timer_restarts_the_wall_clock(capsys):
    PortPrinter.reset_instance()
    printer = PortPrinter()
    printer.t_start -= 1000.0
    before = time.time()
    printer.start_timer()
    assert printer.t_start >= before
    printer.close()
    PortPrinter.reset_instance()
    wall = [ln for ln in printer.lines if "wall-clock" in ln]
    assert wall and float(wall[0].split()[1]) < 100.0
