"""SCIP-style settings-file loader.

The reference ships ``settings/*.set`` files ("param = value" lines, SCIP
names).  This maps the SCIP-SDP parameter names onto our Settings tree so
reference setting files drive this framework too:

    settings = load_settings_file("settings/lp_approx.set")
"""

from __future__ import annotations

import dataclasses

from scipsdp_tpu.utils.config import Settings

# SCIP(-SDP) parameter name -> (section, field, type)
_PARAM_MAP = {
    "misc/solvesdps": ("", "solve_sdps", int),
    "numerics/feastol": ("bb", "feastol", float),
    "numerics/dualfeastol": ("bb", "dualfeastol", float),
    "limits/nodes": ("bb", "node_limit", int),
    "limits/time": ("bb", "time_limit", float),
    "limits/gap": ("bb", "gaplimit", float),
    "relaxing/SDP/sdpsolvergaptol": ("ipm", "gaptol", float),
    "relaxing/SDP/sdpsolverfeastol": ("ipm", "feastol", float),
    "relaxing/SDP/penaltyparam": ("ipm", "penaltyparam", float),
    "relaxing/SDP/maxpenaltyparam": ("ipm", "maxpenaltyparam", float),
    "relaxing/SDP/npenaltyincr": ("ipm", "npenaltyincr", int),
    "relaxing/SDP/peninfeasadjust": ("ipm", "peninfeasadjust", float),
    "relaxing/SDP/warmstart": ("bb", "warmstart", bool),
    "relaxing/SDP/warmstartipfactor": ("ipm", "warmstartipfactor", float),
    "relaxing/SDP/warmstartproject": ("bb", "warmstartproject", int),
    "relaxing/SDP/warmstartroundonlyinf": ("bb", "warmstartroundonlyinf",
                                           bool),
    "relaxing/SDP/warmstartpreoptsol": ("bb", "warmstartpreoptsol", bool),
    "relaxing/SDP/warmstartpreoptgap": ("bb", "warmstartpreoptgap", float),
    "relaxing/SDP/warmstartiptype": ("bb", "warmstartiptype", int),
    "relaxing/SDP/slatercheck": ("bb", "slatercheck", int),
    "relaxing/SDP/conflictconss": ("bb", "conflictconss", bool),
    "relaxing/SDP/conflictfeas": ("bb", "conflictfeas", bool),
    "relaxing/SDP/conflictinfeas": ("bb", "conflictinfeas", bool),
    "relaxing/SDP/conflictcmir": ("bb", "conflictcmir", bool),
    "constraints/SDP/diaggezerocuts": ("presolve", "diaggezerocuts", bool),
    "constraints/SDP/twominorlinconss": ("presolve", "twominorlinconss",
                                         bool),
    "constraints/SDP/diagzeroimplcuts": ("presolve", "diagzeroimplcuts",
                                         bool),
    "constraints/SDP/twominorprodconss": ("presolve", "twominorprodconss",
                                          bool),
    "constraints/SDP/twominorsocconss": ("presolve", "twominorsocconss",
                                         bool),
    "constraints/SDP/enableproptiming": ("bb", "enableproptiming", bool),
    "constraints/SDP/twominorvarbounds": ("presolve", "twominorvarbounds",
                                          bool),
    "constraints/SDP/tightenmatrices": ("presolve", "tightenmatrices", bool),
    "constraints/SDP/presollinconssparam": ("presolve",
                                            "presollinconssparam", int),
    "constraints/SDP/generatecmir": ("cuts", "generatecmir", bool),
    "constraints/SDP/separateonecut": ("cuts", "separateonecut", bool),
    "constraints/SDP/multiplesparsecuts": ("cuts", "multiplesparsecuts",
                                           bool),
    "constraints/SDP/maxnsparsecuts": ("cuts", "maxnsparsecuts", int),
    "constraints/SDP/sparsifyfactor": ("cuts", "sparsifyfactor", float),
    "constraints/SDP/sparsifytargetsize": ("cuts", "sparsifytargetsize",
                                           int),
    "propagating/sdp-symmetry/freq": ("", "use_symmetry", bool),
    # SCIP freq semantics: -1 off, 0 root-only, k every k-th depth; our
    # diving_freq counts batches (0 = off).  Root-only (freq = 0) maps
    # to a sparse cadence (every 100 batches ~ once or twice per
    # testset-scale solve) — a per-batch dive multiplied the testset
    # wall under scip-5.set, far beyond the tier's intent
    "heuristics/sdpfracdiving/freq": ("bb", "diving_freq",
                                      lambda raw: (0 if float(raw) < 0
                                                   else max(int(float(raw)),
                                                            1)
                                                   if float(raw) >= 1
                                                   else 100)),
    "heuristics/sdpfracround/freq": ("bb", "heuristic_fracround", bool),
    "heuristics/sdprand/freq": ("bb", "heuristic_rand", bool),
    "constraints/SDP/enforcesdp": ("bb", "enforcesdp", bool),
    "propagating/sdpobbt/freq": ("bb", "obbt_at_root", bool),
    "branching/sdpmostfrac/priority": None,   # selected via rule name below
    "branching/rule": ("bb", "branching_rule", str),
}

# the reference registers 4 branching plugins and picks the
# highest-priority one (branch_sdp*.c BRANCHRULE_PRIORITY; the tier files
# scip-7/scip-8 promote one rule with priority = 3e+06) — map each
# priority param onto rule selection by maximum value
_BRANCH_PRIO = {
    "branching/sdpmostfrac/priority": "mostfrac",
    "branching/sdpmostinf/priority": "mostinf",
    "branching/sdpobjective/priority": "objective",
    "branching/sdpinfobjective/priority": "infobjective",
}


def _parse_value(raw: str, typ):
    raw = raw.strip()
    if typ is bool:
        if raw.upper() in ("TRUE", "1"):
            return True
        if raw.upper() in ("FALSE", "0", "-1"):
            return False
        return float(raw) > 0
    return typ(raw)


def load_settings_file(path: str, base: Settings = None) -> Settings:
    settings = base or Settings()
    updates = {"": {}, "bb": {}, "ipm": {}, "presolve": {}, "cuts": {}}
    branch_prio = {}
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line or "=" not in line:
                continue
            name, raw = (t.strip() for t in line.split("=", 1))
            if name in _BRANCH_PRIO:
                branch_prio[_BRANCH_PRIO[name]] = float(raw)
                continue
            spec = _PARAM_MAP.get(name)
            if spec is None:
                continue  # unknown params are ignored (SCIP warns only)
            section, field, typ = spec
            updates[section][field] = _parse_value(raw, typ)
    if branch_prio:
        updates["bb"]["branching_rule"] = max(branch_prio,
                                              key=branch_prio.get)

    if updates["bb"]:
        settings = dataclasses.replace(
            settings, bb=dataclasses.replace(settings.bb, **updates["bb"]))
    if updates["ipm"]:
        settings = dataclasses.replace(
            settings, ipm=dataclasses.replace(settings.ipm,
                                              **updates["ipm"]))
    if updates["presolve"]:
        settings = dataclasses.replace(
            settings,
            presolve=dataclasses.replace(settings.presolve,
                                         **updates["presolve"]))
    if updates["cuts"]:
        settings = dataclasses.replace(
            settings, cuts=dataclasses.replace(settings.cuts,
                                               **updates["cuts"]))
    if updates[""]:
        settings = dataclasses.replace(settings, **updates[""])
    return settings
