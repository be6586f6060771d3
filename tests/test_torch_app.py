"""The port's application layer (safeincave_torch.app), twin of
tests/test_app.py: the case builder (validation, discovery, a round trip
run in-process on the CPU, the same document as the JAX package's builder),
the terminal editor's subcommands and CSV import, ``SimulatorRunner``
streaming a child ``sim_cli --device cpu`` (and, asked for the card on a
machine without one, failing in the child with the port's error, never
running on the CPU instead), ``run_script``, and the GUI's headless
helpers.  The window round trip needs a display and skips without one.
"""
import json
import os

import pytest
import torch

from safeincave_torch.app import (InputFileBuilder, SimulatorRunner, editor,
                                  run_script)
from safeincave_torch.mesh.boxgen import box_mesh
from safeincave_torch.mesh.msh_io import write_msh

torch.set_num_threads(1)


@pytest.fixture
def grid_dir(tmp_path):
    d = tmp_path / "grid"
    d.mkdir()
    write_msh(str(d / "geom.msh"), *box_mesh(nx=2, ny=2, nz=2))
    return str(d)


def _build_case(grid_dir, out_dir, builder=InputFileBuilder):
    hourv = 3600.0
    return (builder()
            .set_grid(grid_dir)
            .set_output(out_dir)
            .set_solver(type="KrylovSolver", method="cg",
                        relative_tolerance=1e-12)
            .set_body_force(gravity=0.0, density=2000.0, direction=2)
            .set_time([0.0, hourv, 2 * hourv], theta=0.5)
            .set_equilibrium(active=False)
            .set_operation(active=True, dt_max=hourv)
            .set_elastic("spring", 102e9, 0.3)
            .add_nonelastic("creep", "DislocationCreep",
                            {"A": 1.9e-20, "Q": 51600, "n": 3.0, "T": 298.0})
            .add_dirichlet("WEST", 0, [0.0, 0.0, 0.0])
            .add_dirichlet("SOUTH", 1, [0.0, 0.0, 0.0])
            .add_dirichlet("BOTTOM", 2, [0.0, 0.0, 0.0])
            .add_neumann("TOP", 2, [4e6, 8e6, 8e6]))


class TestBuilder:
    def test_grid_discovery(self, grid_dir):
        b = InputFileBuilder().set_grid(grid_dir)
        assert set(b.data["grid"]["boundaries"]) == {
            "WEST", "EAST", "SOUTH", "NORTH", "BOTTOM", "TOP"}
        assert b.data["grid"]["regions"] == {"BODY": 1}

    def test_same_document_as_the_jax_builder(self, grid_dir):
        from safeincave_tpu.app import InputFileBuilder as JaxBuilder
        assert _build_case(grid_dir, "out").data == \
            _build_case(grid_dir, "out", JaxBuilder).data

    def test_validation_catches_errors(self, grid_dir):
        b = InputFileBuilder()
        errs = b.validate()
        assert any("grid.path" in e for e in errs)
        assert any("elastic" in e for e in errs)
        b = _build_case(grid_dir, "out")
        assert b.validate() == []
        b.add_neumann("EAST", 2, [1e6])
        assert any("EAST" in e for e in b.validate())
        with pytest.raises(ValueError):
            b.add_nonelastic("bad", "DislocationCreep", {"A": 1.0})
        with pytest.raises(ValueError):
            b.add_nonelastic("bad", "NoSuchModel", {})

    def test_roundtrip_and_run(self, grid_dir, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        path = str(tmp_path / "case.json")
        _build_case(grid_dir, str(tmp_path / "out")).save(path)
        b2 = InputFileBuilder.load(path)
        assert b2.validate() == []
        b2.run(device="cpu")   # in-process Simulator_GUI
        assert os.path.isfile(tmp_path / "out" / "operation" / "u" / "u.xdmf")


class TestEditorCLI:
    def test_subcommands(self, grid_dir, tmp_path, capsys):
        path = str(tmp_path / "case.json")
        _build_case(grid_dir, str(tmp_path / "out")).save(path)

        assert editor.main(["show", path]) in (0, None)
        out = capsys.readouterr().out
        assert "boundary conditions" in out and "valid" in out

        editor.main(["set", path, "solver.method", "\"bicgstab\""])
        assert json.load(open(path))["solver_settings"]["method"] == \
            "bicgstab"

        editor.main(["add-bc", path, "EAST", "neumann", "--direction", "2",
                     "--values", "1e6", "2e6", "2e6"])
        blk = json.load(open(path))["boundary_conditions"]["EAST"]
        assert blk["type"] == "neumann" and len(blk["values"]) == 3

        editor.main(["add-element", path, "kelvin", "KelvinVoigt",
                     "--params", "eta=105e11", "E=10e9", "nu=0.32"])
        ne = json.load(open(path))["constitutive_model"]["nonelastic"]
        assert ne["kelvin"]["type"] == "KelvinVoigt"

        assert editor.main(["validate", path]) == 0

    def test_import_csv(self, grid_dir, tmp_path):
        path = str(tmp_path / "case.json")
        _build_case(grid_dir, str(tmp_path / "out")).save(path)
        csv_path = tmp_path / "p.csv"
        csv_path.write_text("tijd;druk_mpa\n0;10,0\n1;12,5\n2;11,0\n")
        editor.main(["import-csv", path, "TOP", str(csv_path)])
        d = json.load(open(path))
        assert d["boundary_conditions"]["TOP"]["values"] == \
            [10.0e6, 12.5e6, 11.0e6]
        assert d["time_settings"]["time_list"] == [0.0, 3600.0, 7200.0]


class TestRunners:
    def test_subprocess_runner_streams_output(self, grid_dir, tmp_path,
                                              monkeypatch):
        monkeypatch.chdir(tmp_path)
        path = str(tmp_path / "case.json")
        _build_case(grid_dir, str(tmp_path / "out")).save(path)
        lines = []
        runner = SimulatorRunner(output_callback=lines.append, device="cpu")
        runner.launch(path)
        rc = runner.wait(timeout=600)
        assert rc == 0, "".join(lines)[-2000:]
        assert os.path.isfile(tmp_path / "out" / "operation" / "u" / "u.xdmf")
        assert any("step" in ln.lower() for ln in lines)

    def test_runner_defaults_to_the_card(self, grid_dir, tmp_path,
                                         monkeypatch):
        monkeypatch.chdir(tmp_path)
        path = str(tmp_path / "case.json")
        _build_case(grid_dir, str(tmp_path / "out")).save(path)
        lines = []
        runner = SimulatorRunner(output_callback=lines.append)
        assert runner.device == "cuda"
        if torch.cuda.is_available():
            return
        runner.launch(path)
        rc = runner.wait(timeout=600)
        text = "".join(lines)
        assert rc != 0, text[-2000:]
        assert 'device="cpu"' in text
        assert not os.path.exists(tmp_path / "out" / "operation")

    def test_script_runner_captures_output(self, tmp_path):
        script = tmp_path / "user.py"
        script.write_text("x = 6 * 7\nprint('answer', x)\n")
        ok, out, ns = run_script(str(script))
        assert ok and "answer 42" in out and ns["x"] == 42
        ok, out, _ = run_script("raise RuntimeError('boom')")
        assert not ok and "boom" in out


def _has_display():
    try:
        import tkinter
        root = tkinter.Tk()
        root.destroy()
        return True
    except Exception:
        return False


class TestGsApp:
    def test_helpers_headless(self):
        from safeincave_torch.app import gsapp
        assert gsapp._parse_number_list("1, 2.5\n3e6") == [1.0, 2.5, 3e6]
        assert gsapp._fmt([1, 2]) == "[1, 2]"
        assert gsapp._fmt(0.5) == "0.5"
        import safeincave_torch.app as app_pkg
        assert callable(app_pkg.gui)
        assert set(gsapp._ELASTIC_PARAMS) == {"E", "nu"}

    def test_gui_roundtrip(self, grid_dir, tmp_path):
        if not _has_display():
            pytest.skip("no X display")
        from safeincave_torch.app.gsapp import GsApp
        path = str(tmp_path / "case.json")
        _build_case(grid_dir, str(tmp_path / "out")).save(path)
        app = GsApp(path)
        try:
            app.root.update_idletasks()
            app.theta_e.delete(0, "end")
            app.theta_e.insert(0, "1.0")
            app.cm_tab.name_e.insert(0, "kv")
            app.cm_tab.type_cb.set("KelvinVoigt")
            app.cm_tab.type_select_change()
            for p, v in (("eta", "105e11"), ("E", "10e9"), ("nu", "0.32")):
                app.cm_tab.param_entries[p].insert(0, v)
            app.cm_tab.add_or_update()
            out = str(tmp_path / "case2.json")
            assert app.save_to_file(out) == out
            d = json.load(open(out))
            assert d["time_settings"]["theta"] == 1.0
            kv = d["constitutive_model"]["nonelastic"]["kv"]
            assert kv["type"] == "KelvinVoigt"
            assert kv["parameters"]["nu"] == 0.32
        finally:
            app.root.destroy()
