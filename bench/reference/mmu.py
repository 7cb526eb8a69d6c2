"""A plain, one-lane, scalar simulator of the translation path the
benchmark's cells run: the split L1 D-TLBs, the unified L2 TLB, Victima
(TLB blocks in the L2 cache, the PTW cost predictor, TLB-aware SRRIP,
eviction-triggered background walks), the four-level radix walker with
its page-walk caches, the nested-paging 2-D walk with the nested TLB
(and Victima's nested-TLB blocks), and the L1D / L2 / L3 cache
hierarchy with the L2 stream prefetcher and the two background lines an
access.  Table 3 of the Victima paper (arXiv:2310.04158) sizes it; the
geometry comes from the benchmark's configuration files.

Written from the semantics the simulator is specified by, one access at
a time, in Python integers and lists, with no code of the program under
test.  A member of a ladder is simulated as a system of its own size:
the ladder's per-lane views of larger structures must give the same
statistics as structures of the member's own geometry.

Integer counters are exact.  The ``sum_*`` statistics are float32 sums
added one access at a time (``sum_dtype`` selects the accumulation type:
the control of the correctness check accumulates in bfloat16).
"""
from __future__ import annotations

import numpy as np

RRIP_MAX = 3
BT_DATA, BT_TLB4, BT_TLB2, BT_NTLB = 0, 1, 2, 3
REUSE_BUCKETS = 22   # reuse counts 0..20, bucket 21 holds ">20"
HIST_BUCKETS = 64    # 10-cycle buckets of a walk's latency
PWC_SETS, PWC_WAYS, PWC_LAT = 8, 4, 2
FREQ_MAX, COST_MAX = 7, 15  # the PTW-CP's 3-bit and 4-bit counters

# line-id bases of the page-table regions (64-byte lines)
_B, _W = 1 << 29, 1 << 22
LEAF4_BASE, PD_BASE, PDP_BASE, PML4_BASE = (_B, _B + _W, _B + 2 * _W,
                                            _B + 3 * _W)
HLEAF_BASE, HPD_BASE, HPDP_BASE, HPML4_BASE = (_B + 4 * _W, _B + 5 * _W,
                                               _B + 6 * _W, _B + 7 * _W)

# the two background lines of an access: ((now * MUL) ^ salt) & MASK
_BG_MUL = -1640531527
_BG_SALTS = (-1640531527, -2048144789)
_BG_MASK = (1 << 26) - 1
_HASH_MUL = -1640531535  # the host-page counter table's hash

STATS_FIELDS = (
    "n_access", "n_l1tlb_hit", "n_l2tlb_hit", "n_l2tlb_miss",
    "n_victima_hit", "n_l3tlb_hit", "n_pom_hit", "n_demand_ptw", "n_bg_ptw",
    "n_host_ptw", "n_ntlb_hit", "n_nvictima_hit", "sum_trans_cyc",
    "sum_l2miss_cyc", "sum_data_cyc", "sum_walk_cyc", "hist_walk",
    "sum_tlb4_live", "sum_tlb2_live", "n_restseg_hit", "n_restseg_miss",
    "n_restseg_mig", "n_restseg_conflict", "sum_restseg_cyc",
    "hist_restseg", "n_rev_hit", "n_rev_mispred", "n_rev_enroll",
    "sum_rev_verify_cyc", "hist_rev_verify")

# configuration values outside what this simulator models: a system that
# sets one of them is refused
UNMODELLED = {"l3tlb_sets": 0, "pom": False, "utopia": False,
              "revelator": False, "n_cores": 1, "dram_cache_sets": 0,
              "collect": False}


def _bf16_round(x: np.float32) -> np.float32:
    """A float32 value rounded to bfloat16 (nearest, ties to even)."""
    b = int(np.array(x, np.float32).view(np.uint32))
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return np.array(b, np.uint32).view(np.float32)[()]


def float_sum(values, sum_dtype: str = "float32") -> np.float32:
    """The sum of `values` added one at a time, in order, in `sum_dtype`
    (``float32``; ``bfloat16`` rounds after every addition)."""
    a = np.asarray(values, np.float32)
    if sum_dtype == "float32":
        return np.cumsum(a, dtype=np.float32)[-1] if len(a) else \
            np.float32(0)
    if sum_dtype != "bfloat16":
        raise ValueError(f"unknown sum_dtype {sum_dtype!r}")
    acc = np.float32(0)
    for v in a:
        acc = _bf16_round(np.float32(acc + v))
    return acc


def _check(cfg: dict) -> None:
    for k, v in UNMODELLED.items():
        if cfg.get(k, v) != v:
            raise ValueError(f"the reference does not model {k}={cfg[k]!r}")
    for k in ("l1d4_sets", "l1d2_sets", "l2tlb_sets", "l1_sets", "l2_sets",
              "l3_sets", "ntlb_sets", "n_pages4", "n_pages2", "n_pagesh"):
        if cfg[k] & (cfg[k] - 1):
            raise ValueError(f"{k}={cfg[k]} is not a power of two")


def _lru(sets: int, ways: int):
    """An LRU structure: rows of keys (-1: invalid way) and of stamps."""
    return [[-1] * ways for _ in range(sets)], [[0] * ways for _ in
                                                range(sets)]


def _lru_insert(keys, stamps, s: int, key: int, now: int):
    """Put `key` into set `s` over its LRU way (the first invalid way, else
    the first least-recently stamped); returns (evicted key, valid).  An
    invalid way's key reads 0, as a never-written tag does."""
    row = keys[s]
    st = stamps[s]
    if -1 in row:
        w = row.index(-1)
        ev, ev_valid = 0, False
    else:
        w = st.index(min(st))
        ev, ev_valid = row[w], True
    row[w] = key
    st[w] = now
    return ev, ev_valid


def simulate(cfg: dict, trace: dict, sum_dtype: str = "float32"):
    """Simulate one lane of system `cfg` (a SimConfig as a dict, with
    ``lat`` a dict) over `trace` (``vpn``, ``is2m``, ``line`` arrays and
    the workload's ``ipa``).  Returns (stats, extras): dicts of numpy
    values, with the program's names."""
    _check(cfg)
    lat = cfg["lat"]
    LAT_L1D, LAT_L2, LAT_L3, LAT_DRAM = (lat["l1d"], lat["l2"], lat["l3"],
                                         lat["dram"])
    victima = bool(cfg["victima"])
    tlb_aware = bool(cfg["tlb_aware"])
    use_ptwcp = bool(cfg["use_ptwcp"])
    nested = bool(cfg["virt"]) and not cfg["ideal_shadow"]
    l1tlb_lat, l2tlb_lat = cfg["l1tlb_lat"], cfg["l2tlb_lat"]
    m4, m2, mh = cfg["n_pages4"] - 1, cfg["n_pages2"] - 1, cfg["n_pagesh"] - 1

    L1D4K, L1D4M = _lru(cfg["l1d4_sets"], cfg["l1d4_ways"])
    L1D2K, L1D2M = _lru(cfg["l1d2_sets"], cfg["l1d2_ways"])
    L2TK, L2TM = _lru(cfg["l2tlb_sets"], cfg["l2tlb_ways"])
    P4K, P4M = _lru(PWC_SETS, PWC_WAYS)
    P3K, P3M = _lru(PWC_SETS, PWC_WAYS)
    P2K, P2M = _lru(PWC_SETS, PWC_WAYS)
    L1K, L1M = _lru(cfg["l1_sets"], cfg["l1_ways"])
    NTK, NTM = _lru(cfg["ntlb_sets"], cfg["ntlb_ways"])
    l1d4_mask, l1d2_mask = cfg["l1d4_sets"] - 1, cfg["l1d2_sets"] - 1
    l2tlb_mask, l1_mask = cfg["l2tlb_sets"] - 1, cfg["l1_sets"] - 1
    nt_mask = cfg["ntlb_sets"] - 1
    # the L2 cache: rows of keys (tag * 4 + block type; -1 invalid), RRPVs
    # and reuse counts; the L3: rows of tags and RRPVs
    l2_mask, l2_ways = cfg["l2_sets"] - 1, cfg["l2_ways"]
    L2K = [[-1] * l2_ways for _ in range(cfg["l2_sets"])]
    L2R = [[0] * l2_ways for _ in range(cfg["l2_sets"])]
    L2U = [[0] * l2_ways for _ in range(cfg["l2_sets"])]
    l3_mask = cfg["l3_sets"] - 1
    L3K = [[-1] * cfg["l3_ways"] for _ in range(cfg["l3_sets"])]
    L3R = [[0] * cfg["l3_ways"] for _ in range(cfg["l3_sets"])]
    live = [0, 0, 0, 0]  # live L2 blocks by type (index 0 unused)
    hist_data = [0] * REUSE_BUCKETS
    hist_tlb = [0] * REUSE_BUCKETS
    PC4F, PC4C = bytearray(m4 + 1), bytearray(m4 + 1)
    PC2F, PC2C = bytearray(m2 + 1), bytearray(m2 + 1)
    PCHF, PCHC = bytearray(mh + 1), bytearray(mh + 1)
    # n_l2_access, n_l2_miss, n_l3_access, n_l3_trans
    hc = [0, 0, 0, 0]

    def predict(f, c):
        return (not use_ptwcp) or (1 <= c <= 12 and 1 <= f <= FREQ_MAX)

    def l2_find(key, bt):
        s = key & l2_mask
        ck = key * 4 + bt
        row = L2K[s]
        return s, (row.index(ck) if ck in row else -1)

    def l2_touch(s, w, pressure):
        r = L2R[s]
        dec = 3 if (tlb_aware and pressure and L2K[s][w] & 3) else 1
        r[w] = r[w] - dec if r[w] > dec else 0
        L2U[s][w] += 1

    def l2_insert(key, bt, pressure):
        s = key & l2_mask
        keys = L2K[s]
        rr = L2R[s]
        if -1 in keys:  # the first invalid way, nothing ages
            w = keys.index(-1)
        else:  # SRRIP: age the row until a way reaches RRIP_MAX
            bump = RRIP_MAX - max(rr)
            if bump:
                rr = L2R[s] = [r + bump for r in rr]
            w = rr.index(RRIP_MAX)
            old = keys[w]
            if tlb_aware and pressure and old & 3:
                # Listing 1: one more try for a non-TLB way at RRIP_MAX
                for j, k in enumerate(keys):
                    if not k & 3 and rr[j] >= RRIP_MAX:
                        w = j
                        old = k
                        break
            obt = old & 3
            b = L2U[s][w]
            b = b if b < REUSE_BUCKETS - 1 else REUSE_BUCKETS - 1
            if obt:
                hist_tlb[b] += 1
                live[obt] -= 1
            else:
                hist_data[b] += 1
        rr[w] = 0 if (tlb_aware and pressure and bt) else RRIP_MAX - 1
        keys[w] = key * 4 + bt
        L2U[s][w] = 0
        if bt:
            live[bt] += 1

    def l2_retag(key, bt, pressure):
        if l2_find(key, bt)[1] < 0:
            l2_insert(key, bt, pressure)

    def l3_access(key):
        s = key & l3_mask
        keys = L3K[s]
        if key in keys:
            L3R[s][keys.index(key)] = 0
            return True
        rr = L3R[s]
        if -1 in keys:
            w = keys.index(-1)
        else:
            bump = RRIP_MAX - max(rr)
            if bump:
                rr = L3R[s] = [r + bump for r in rr]
            w = rr.index(RRIP_MAX)
        rr[w] = RRIP_MAX - 1
        keys[w] = key
        return False

    def access_pte(line, pressure):
        """A walker's access to a page-table line: (cycles, went to DRAM)."""
        s, w = l2_find(line, BT_DATA)
        if w >= 0:
            l2_touch(s, w, pressure)
            return LAT_L2, 0
        hit3 = l3_access(line)
        l2_insert(line, BT_DATA, pressure)
        hc[2] += 1
        hc[3] += 1
        return (LAT_L3, 0) if hit3 else (LAT_L3 + LAT_DRAM, 1)

    def pwc_plan(vpn, is2m):
        vpn2 = vpn >> 9
        if is2m:
            lines = (PML4_BASE + ((vpn2 >> 18) >> 3),
                     PDP_BASE + ((vpn2 >> 9) >> 3), PD_BASE + (vpn2 >> 3))
            k4, k3 = vpn2 >> 18, vpn2 >> 9
        else:
            lines = (PML4_BASE + ((vpn >> 27) >> 3),
                     PDP_BASE + ((vpn >> 18) >> 3),
                     PD_BASE + ((vpn >> 9) >> 3), LEAF4_BASE + (vpn >> 3))
            k4, k3 = vpn >> 27, vpn >> 18
        kpd = vpn >> 9
        if not is2m and kpd in P2K[kpd & 7]:
            start = 3
        elif k3 in P3K[k3 & 7]:
            start = 2
        elif k4 in P4K[k4 & 7]:
            start = 1
        else:
            start = 0
        return lines, start, k4, k3, kpd

    def pwc_fill(start, k4, k3, kpd, is2m, now):
        if start <= 0:
            _lru_insert(P4K, P4M, k4 & 7, k4, now)
        if start <= 1:
            _lru_insert(P3K, P3M, k3 & 7, k3, now)
        if start <= 2 and not is2m:
            _lru_insert(P2K, P2M, kpd & 7, kpd, now)

    def walk(vpn, is2m, now, pressure):
        """A radix walk: (cycles, page-table lines from DRAM)."""
        lines, start, k4, k3, kpd = pwc_plan(vpn, is2m)
        cyc, nd = PWC_LAT, 0
        for ln in lines[start:]:
            c, d = access_pte(ln, pressure)
            cyc += c
            nd += d
        pwc_fill(start, k4, k3, kpd, is2m, now)
        return cyc, nd

    def host_walk(gpn, pressure):
        cyc = nd = 0
        for ln in (HPML4_BASE + ((gpn >> 27) >> 3),
                   HPDP_BASE + ((gpn >> 18) >> 3),
                   HPD_BASE + ((gpn >> 9) >> 3), HLEAF_BASE + (gpn >> 3)):
            c, d = access_pte(ln, pressure)
            cyc += c
            nd += d
        return cyc, nd

    def count(F, C, i, dram):
        F[i] = min(F[i] + 1, FREQ_MAX)
        C[i] = min(C[i] + dram, COST_MAX)

    def nested_translate(gpn, now, pressure, bypass):
        """gPA page -> hPA: (cycles, host walk, nested-TLB hit, Victima
        nested-TLB-block hit)."""
        s = gpn & nt_mask
        row = NTK[s]
        if gpn in row:
            NTM[s][row.index(gpn)] = now
            return 1, 0, 1, 0
        cyc, vhit = 1, 0
        if victima:
            vs, vw = l2_find(gpn >> 3, BT_NTLB)
            if vw >= 0:
                vhit = 1
                l2_touch(vs, vw, pressure)
                cyc += LAT_L2
        walked = 1 - vhit
        if walked:
            wc, nd = host_walk(gpn, pressure)
            cyc += wc
            hidx = (gpn * _HASH_MUL) & mh
            count(PCHF, PCHC, hidx, nd >= 1)
            if victima and (predict(PCHF[hidx], PCHC[hidx]) or bypass):
                l2_retag(gpn >> 3, BT_NTLB, pressure)
        ev, ev_valid = _lru_insert(NTK, NTM, s, gpn, now)
        if victima and ev_valid:
            eidx = (ev * _HASH_MUL) & mh
            if predict(PCHF[eidx], PCHC[eidx]) or bypass:
                _, bd = host_walk(ev, pressure)
                count(PCHF, PCHC, eidx, bd >= 1)
                l2_retag(ev >> 3, BT_NTLB, pressure)
        return cyc, walked, 0, vhit

    def walk_2d(vpn, is2m, now, pressure, bypass):
        """A nested-paging walk: (cycles, guest-PT lines from DRAM, host
        walks, nested-TLB hits, nested-TLB-block hits)."""
        lines, start, k4, k3, kpd = pwc_plan(vpn, is2m)
        cyc, nd, nh, nt, nv = PWC_LAT, 0, 0, 0, 0
        for ln in lines[start:]:
            ncyc, walked, th, vh = nested_translate(ln >> 6, now, pressure,
                                                    bypass)
            c, d = access_pte(ln, pressure)
            cyc += ncyc + c
            nd += d
            nh += walked
            nt += th
            nv += vh
        pwc_fill(start, k4, k3, kpd, is2m, now)
        ncyc, walked, th, vh = nested_translate(vpn, now, pressure, bypass)
        return cyc + ncyc, nd, nh + walked, nt + th, nv + vh

    def access_data(line, now, pressure):
        s1 = line & l1_mask
        row = L1K[s1]
        if line in row:
            L1M[s1][row.index(line)] = now
            cyc = LAT_L1D
        else:
            L1M[s1][0] = now  # a miss stamps way 0 of the set
            s2, w2 = l2_find(line, BT_DATA)
            hc[0] += 1
            if w2 >= 0:
                l2_touch(s2, w2, pressure)
                cyc = LAT_L2
            else:
                hit3 = l3_access(line)
                l2_insert(line, BT_DATA, pressure)
                if l2_find(line + 1, BT_DATA)[1] < 0:  # next-line prefetch
                    l2_insert(line + 1, BT_DATA, pressure)
                hc[1] += 1
                hc[2] += 1
                cyc = LAT_L3 if hit3 else LAT_L3 + LAT_DRAM
            _lru_insert(L1K, L1M, s1, line, now)
        for salt in _BG_SALTS:
            bg = ((now * _BG_MUL) ^ salt) & _BG_MASK
            if not l3_access(bg):
                l2_insert(bg, BT_DATA, pressure)
        return cyc

    # the float32 signals: instructions so far (at least 1) times the
    # thresholds, and a count of misses times 1000, each rounded to float32
    n = len(trace["vpn"])
    f32 = np.float32
    instrs = np.maximum(np.arange(n), 1).astype(f32) * f32(trace["ipa"])
    press_at = (f32(cfg["pressure_mpki"]) * instrs).tolist()
    bypass_at = (f32(cfg["bypass_l2mpki"]) * instrs).tolist()
    per_mille = (np.arange(n + 1).astype(f32) * f32(1000.0)).tolist()
    vpns = trace["vpn"].tolist()
    is2ms = trace["is2m"].tolist()
    lines_ = trace["line"].tolist()
    c = dict.fromkeys(("n_l1tlb_hit", "n_l2tlb_hit", "n_l2tlb_miss",
                       "n_victima_hit", "n_demand_ptw", "n_bg_ptw",
                       "n_host_ptw", "n_ntlb_hit", "n_nvictima_hit"), 0)
    hist_walk = [0] * HIST_BUCKETS
    s_trans, s_l2miss, s_data, s_walk, s_tlb4, s_tlb2 = ([], [], [], [],
                                                         [], [])
    n_l1hit = n_l2hit = n_miss2 = n_vhit = n_walk = n_bg = 0
    n_host = n_nt = n_nv = 0
    now = 0
    for t in range(n):
        vpn, is2m, line = vpns[t], is2ms[t], lines_[t]
        now += 1
        # translation pressure and the L2-cache bypass, from the counts
        # before this access
        pressure = per_mille[n_miss2] > press_at[t]
        bypass = per_mille[hc[1]] >= bypass_at[t]
        vpn2 = vpn >> 9
        if is2m:
            s = vpn2 & l1d2_mask
            row = L1D2K[s]
            hit1 = vpn2 in row
            if hit1:
                L1D2M[s][row.index(vpn2)] = now
        else:
            s = vpn & l1d4_mask
            row = L1D4K[s]
            hit1 = vpn in row
            if hit1:
                L1D4M[s][row.index(vpn)] = now
        trans = l1tlb_lat
        past = 0
        miss2 = vhit = walk_en = bg = 0
        wcyc = 0
        if hit1:
            n_l1hit += 1
        else:
            trans += l2tlb_lat
            key2 = ((vpn2 if is2m else vpn) << 1) | is2m
            s = key2 & l2tlb_mask
            row = L2TK[s]
            if key2 in row:
                L2TM[s][row.index(key2)] = now
                n_l2hit += 1
            else:
                miss2 = 1
                vkey = (vpn2 if is2m else vpn) >> 3
                vbt = BT_TLB2 if is2m else BT_TLB4
                if victima:
                    vs, vw = l2_find(vkey, vbt)
                    if vw >= 0:
                        vhit = 1
                        l2_touch(vs, vw, pressure)
                        past += LAT_L2
                ndram = 0
                if not vhit:
                    walk_en = 1
                    if nested:
                        wcyc, ndram, nh, nt, nv = walk_2d(vpn, is2m, now,
                                                          pressure, bypass)
                        n_host += nh
                        n_nt += nt
                        n_nv += nv
                    else:
                        wcyc, ndram = walk(vpn, is2m, now, pressure)
                    past += wcyc
                # ---- fills
                d4, d2 = vpn & m4, vpn2 & m2
                if victima:
                    ev, ev_valid = _lru_insert(L2TK, L2TM, s, key2, now)
                    ev_vpn, ev2m = ev >> 1, ev & 1
                    bg_vpn4 = ev_vpn << 9 if ev2m else ev_vpn
                    b4, b2 = bg_vpn4 & m4, ev_vpn & m2
                    f4 = (PC4F[d4], PC4F[b4])
                    c4 = (PC4C[d4], PC4C[b4])
                    f2 = (PC2F[d2], PC2F[b2])
                    c2 = (PC2C[d2], PC2C[b2])
                    dr0 = 1 if ndram >= 1 else 0
                    fpost = (f2[0] if is2m else f4[0]) + walk_en
                    cpost = (c2[0] if is2m else c4[0]) + (walk_en & dr0)
                    if walk_en and (predict(min(fpost, FREQ_MAX),
                                            min(cpost, COST_MAX)) or bypass):
                        l2_retag(vkey, vbt, pressure)
                    fe, ce = (f2[1], c2[1]) if ev2m else (f4[1], c4[1])
                    dr1 = 0
                    if ev_valid and (predict(fe, ce) or bypass):
                        bg = 1
                        _, bd = walk(bg_vpn4, ev2m, now, pressure)
                        dr1 = 1 if bd >= 1 else 0
                        l2_retag(ev_vpn >> 3, BT_TLB2 if ev2m else BT_TLB4,
                                 pressure)
                    # the two counter slots: the demand page's, then the
                    # background page's (read before, written after; the
                    # second wins where the two indices meet)
                    e40, e20 = walk_en & (1 - is2m), walk_en & is2m
                    e41, e21 = bg & (1 - ev2m), bg & ev2m
                    PC4F[d4] = min(f4[0] + e40, FREQ_MAX)
                    PC4C[d4] = min(c4[0] + (e40 & dr0), COST_MAX)
                    PC2F[d2] = min(f2[0] + e20, FREQ_MAX)
                    PC2C[d2] = min(c2[0] + (e20 & dr0), COST_MAX)
                    PC4F[b4] = min(f4[1] + e41, FREQ_MAX)
                    PC4C[b4] = min(c4[1] + (e41 & dr1), COST_MAX)
                    PC2F[b2] = min(f2[1] + e21, FREQ_MAX)
                    PC2C[b2] = min(c2[1] + (e21 & dr1), COST_MAX)
                else:
                    if walk_en:
                        if is2m:
                            count(PC2F, PC2C, d2, ndram >= 1)
                        else:
                            count(PC4F, PC4C, d4, ndram >= 1)
                    _lru_insert(L2TK, L2TM, s, key2, now)
            if is2m:
                _lru_insert(L1D2K, L1D2M, vpn2 & l1d2_mask, vpn2, now)
            else:
                _lru_insert(L1D4K, L1D4M, vpn & l1d4_mask, vpn, now)
        dcyc = access_data(line, now, pressure)

        n_miss2 += miss2
        n_vhit += vhit
        n_walk += walk_en
        n_bg += bg
        s_trans.append(trans + past)
        s_l2miss.append(past if miss2 else 0)
        s_data.append(dcyc)
        s_walk.append(wcyc if walk_en else 0)
        if walk_en:
            hist_walk[min(wcyc // 10, HIST_BUCKETS - 1)] += 1
        s_tlb4.append(live[BT_TLB4])
        s_tlb2.append(live[BT_TLB2])

    # still-resident blocks join the reuse histograms
    hd, ht = list(hist_data), list(hist_tlb)
    for keys, reuse in zip(L2K, L2U):
        for k, r in zip(keys, reuse):
            if k >= 0:
                (ht if k & 3 else hd)[min(r, REUSE_BUCKETS - 1)] += 1

    i32 = np.int32
    zeros = np.zeros(HIST_BUCKETS, np.int32)
    c.update(n_l1tlb_hit=n_l1hit, n_l2tlb_hit=n_l2hit, n_l2tlb_miss=n_miss2,
             n_victima_hit=n_vhit, n_demand_ptw=n_walk, n_bg_ptw=n_bg,
             n_host_ptw=n_host, n_ntlb_hit=n_nt, n_nvictima_hit=n_nv)
    stats = {k: i32(v) for k, v in c.items()}
    stats.update(
        n_access=i32(n), n_l3tlb_hit=i32(0), n_pom_hit=i32(0),
        sum_trans_cyc=float_sum(s_trans, sum_dtype),
        sum_l2miss_cyc=float_sum(s_l2miss, sum_dtype),
        sum_data_cyc=float_sum(s_data, sum_dtype),
        sum_walk_cyc=float_sum(s_walk, sum_dtype),
        hist_walk=np.asarray(hist_walk, np.int32),
        sum_tlb4_live=float_sum(s_tlb4, sum_dtype),
        sum_tlb2_live=float_sum(s_tlb2, sum_dtype),
        n_restseg_hit=i32(0), n_restseg_miss=i32(0), n_restseg_mig=i32(0),
        n_restseg_conflict=i32(0), sum_restseg_cyc=np.float32(0),
        hist_restseg=zeros.copy(), n_rev_hit=i32(0), n_rev_mispred=i32(0),
        n_rev_enroll=i32(0), sum_rev_verify_cyc=np.float32(0),
        hist_rev_verify=zeros.copy())
    extras = {"l2_access": hc[0], "l2_miss": hc[1],
              "hist_reuse_data": np.asarray(hd, np.int32),
              "hist_reuse_tlb": np.asarray(ht, np.int32)}
    return {k: stats[k] for k in STATS_FIELDS}, extras
