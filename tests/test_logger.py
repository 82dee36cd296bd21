"""Leveled per-component logger (utils/logger/logger.hpp:161 +
configs/debruijn/log.properties equivalent)."""

import importlib

from spades_for_blackbird_tpu.utils import logger as logmod


def setup_function(_):
    importlib.reload(logmod)


def test_level_filtering_and_properties(tmp_path, monkeypatch):
    props = tmp_path / "log.properties"
    props.write_text(
        "; comment\n"
        "default=WARN\n"
        "Simplification=DEBUG\n"
        "KMerCounter=ERROR  # trailing comment\n")
    lines = []
    monkeypatch.delenv("SPADES_TPU_LOG", raising=False)
    logmod.configure(str(props), writers=[lines.append])
    logmod.get_logger("Simplification").debug("tips clipped")
    logmod.get_logger("Simplification").trace("invisible")
    logmod.get_logger("KMerCounter").warn("suppressed")
    logmod.get_logger("KMerCounter").error("boom")
    logmod.get_logger("Other").info("below default")
    logmod.get_logger("Other").warn("visible")
    text = "\n".join(lines)
    assert "tips clipped" in text and "[Simplification]" in text
    assert "invisible" not in text
    assert "suppressed" not in text and "boom" in text
    assert "below default" not in text and "visible" in text


def test_env_overlay(monkeypatch):
    lines = []
    monkeypatch.setenv("SPADES_TPU_LOG", "debug,Quiet=error")
    logmod.configure(writers=[lines.append])
    logmod.get_logger("Any").debug("dbg on")
    logmod.get_logger("Quiet").warn("muted")
    assert any("dbg on" in l for l in lines)
    assert not any("muted" in l for l in lines)


def test_bad_level_raises():
    import pytest
    with pytest.raises(ValueError):
        logmod.parse_level("chatty")


def test_cli_restores_writers_after_bad_input(tmp_path):
    from spades_for_blackbird_tpu import cli
    missing = str(tmp_path / "missing.fq")
    out = tmp_path / "out"
    assert cli.main(["-1", missing, "-2", missing, "-o", str(out)]) == 2
    # the run's spades.log writer is gone: logging afterwards neither
    # writes to the closed file nor raises
    logmod.get_logger("pipeline").info("after the run")
    assert "after the run" not in (out / "spades.log").read_text()
