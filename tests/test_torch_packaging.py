"""The port's package data: a wheel ships every file the kernel build
reads, so a non-editable install can build the kernels."""

import tomllib
from fnmatch import fnmatch
from pathlib import Path

import pytest

import fastselect_tpu_torch
from fastselect_tpu_torch import _build

REPO = Path(__file__).resolve().parent.parent
PACKAGE = Path(fastselect_tpu_torch.__file__).resolve().parent


def _patterns():
    cfg = tomllib.loads((REPO / "pyproject.toml").read_text())
    return cfg["tool"]["setuptools"]["package-data"]["fastselect_tpu_torch"]


def test_build_reads_sources_and_headers():
    suffixes = {src.suffix for src in _build._sources()}
    assert suffixes == {".cu", ".cuh"}


@pytest.mark.parametrize("src", [p.name for p in _build._sources()])
def test_package_data_ships_build_source(src):
    rel = (_build.CSRC / src).resolve().relative_to(PACKAGE).as_posix()
    assert any(fnmatch(rel, pat) for pat in _patterns()), rel
