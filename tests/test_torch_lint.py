"""The port lies inside pmemlint: ``python -m repro.analysis.lint
src/repro_torch`` reports no new finding, and the lint's recovery pass
finds the port's ``@metadata_only`` roots (the counterparts of those of
``src/repro/core/checkpoint.py``, ``tiered_io.py``,
``dataset_exchange.py``, ``workflow.py`` and ``serve/sessions.py``: the
ack ranking of lost-node restores, the repair scans, the catalog's
recoverability and the sessions' decisions), so it checks the port and
not an empty graph."""
from pathlib import Path

import pytest

from repro.analysis import lint, recovery
from repro.analysis.core import collect

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
# the port's counterparts of JAX's @metadata_only functions
ROOTS = ("DistributedCheckpointer._meta_get_json",
         "DistributedCheckpointer.ack_record",
         "DistributedCheckpointer.acks",
         "DistributedCheckpointer.latest_step",
         "DistributedCheckpointer.available_steps",
         "SaveTicket.durability", "_acked_level",
         "DistributedCheckpointer._acks_plausible", "RepairChannel._plan",
         "RepairChannel.repair", "RepairChannel._scan_checkpoints",
         "RepairChannel._scan_dlm", "RepairChannel._scan_datasets",
         "DatasetCatalog.versions", "DatasetCatalog.latest_version",
         "DatasetCatalog.record", "DatasetCatalog.recoverable",
         "WorkflowScheduler._legacy_journal", "WorkflowScheduler.journal",
         "SessionManager.discover", "SessionManager.choose_evictions",
         "SessionManager.recoverable_sessions")
# the counterparts of JAX's @rehydration_entry copy entry points
ENTRIES = ("DataScheduler.replicate", "copy_object",
           "ReplicationChannel.submit", "ReplicationChannel.replicate_object",
           "DataScheduler.drain", "export_object", "import_object",
           "ExchangeChannel.submit")


def _decorated(marker: str) -> set:
    return {fn.qualname for mod in collect([PORT], ROOT)
            for fn in mod.functions.values() if marker in fn.decorators}


def test_lint_reports_no_new_finding_on_the_port(capsys):
    assert lint.main([str(PORT)]) == 0
    assert "0 new" in capsys.readouterr().out


def test_lint_reports_nothing_on_the_port_without_the_baseline():
    assert lint.run_lint([PORT], ROOT) == []


@pytest.mark.parametrize("qualname", ROOTS)
def test_recovery_pass_sees_the_metadata_only_roots(qualname):
    assert qualname in _decorated("metadata_only")


def test_stage_in_is_a_rehydration_entry():
    assert "DataScheduler.stage_in" in _decorated("rehydration_entry")


@pytest.mark.parametrize("qualname", ENTRIES)
def test_copy_paths_are_rehydration_entries(qualname):
    assert qualname in _decorated("rehydration_entry")


def test_lint_flags_the_heartbeat_swallow_without_its_suppression(
        tmp_path):
    """The suppression is what keeps the port clean: the same file with
    the comment taken out gives the silent-swallow finding."""
    src = (PORT / "core" / "resilience.py").read_text()
    marker = "  # pmemlint: disable=silent-swallow"
    assert src.count(marker) == 1
    bare = tmp_path / "resilience.py"
    bare.write_text(src.replace(marker, ""))
    rules = [f.rule for f in lint.run_lint([bare], tmp_path)]
    assert rules == ["silent-swallow"]


def test_recovery_pass_flags_a_payload_read_from_a_port_root(tmp_path):
    """A metadata-only root of the port that reads object bytes is a
    finding: the pass walks the port's graph from its roots."""
    src = (PORT / "core" / "checkpoint.py").read_text()
    old = ('            return self._meta_get_json("ckpt/latest.json")'
           '["step"]')
    assert src.count(old) == 1
    bad = tmp_path / "checkpoint.py"
    bad.write_text(src.replace(old, old + "\n            "
                               "self.stores[0].get_leaf('x', 'y')"))
    found = recovery.run(collect([bad], tmp_path))
    assert any("latest_step" in f.render() for f in found)
