"""Pipeline configuration.

Three mechanisms, matching the reference's (SURVEY.md section 5 "Config"):
CLI flags per tool, an INI file with ``BasicConf`` / ``DiskdbConf`` /
``Baseband2powerConf`` sections (``paf-baseband2power.conf:1-26``), and the
geometry constants module. The INI keys accepted here are a superset of the
reference's; unknown keys are preserved so existing conf files keep working.

A copy of the JAX package's ``config.py``: the same INI gives the same
configuration in both packages (a test holds them equal name by name).
"""

from __future__ import annotations

import configparser
import dataclasses
import typing

from . import constants as C


@dataclasses.dataclass
class BasicConf:
    nsamp_df: int = C.NSAMP_DF
    npol_samp: int = C.NPOL_SAMP
    ndim_pol: int = C.NDIM_POL
    nchk_nic: int = C.NCHK_NIC


@dataclasses.dataclass
class DiskdbConf:
    ndf: int = C.NDF_BLK
    nblk: int = C.DEFAULT_NBLK_IN
    key: str = C.DEFAULT_KEY_IN
    kfname_prefix: str = "diskdb"
    nreader: int = 1
    sod: int = 1
    hfname: str = ""


@dataclasses.dataclass
class Baseband2powerConf:
    key: str = C.DEFAULT_KEY_OUT
    kfname_prefix: str = "baseband2power"
    nreader: int = 1
    sod: int = 1
    nchan: int = C.NCHAN
    nbyte: int = C.NBYTE_OUT
    nblk: int = C.DEFAULT_NBLK_OUT


@dataclasses.dataclass
class PipelineConf:
    basic: BasicConf
    diskdb: DiskdbConf
    baseband2power: Baseband2powerConf

    @property
    def diskdb_rbufsz(self) -> int:
        """Input ring block size (launcher math, paf-baseband2power.py:67)."""
        return self.diskdb.ndf * self.basic.nchk_nic * C.DT_SIZE

    @property
    def baseband2power_rbufsz(self) -> int:
        """Output ring block size (paf-baseband2power.py:79)."""
        return self.baseband2power.nchan * self.baseband2power.nbyte


def _fill(dc, section):
    hints = typing.get_type_hints(dc)
    kwargs = {}
    for f in dataclasses.fields(dc):
        ini_key = f.name.upper()
        if section is not None and ini_key in section:
            raw = section[ini_key].split("#")[0].strip()
            typ = hints[f.name]
            kwargs[f.name] = raw if typ is str else typ(raw)
    return dc(**kwargs)


def load_config(path: str | None = None) -> PipelineConf:
    """Load a reference-format INI config; missing file/sections use the
    reference's default values."""
    cp = configparser.ConfigParser(
        delimiters=(":", "="), inline_comment_prefixes=("#",)
    )
    cp.optionxform = str  # keep keys uppercase
    if path:
        with open(path) as f:
            cp.read_file(f)

    def section(name):
        return cp[name] if cp.has_section(name) else None

    return PipelineConf(
        basic=_fill(BasicConf, section("BasicConf")),
        diskdb=_fill(DiskdbConf, section("DiskdbConf")),
        baseband2power=_fill(Baseband2powerConf, section("Baseband2powerConf")),
    )
