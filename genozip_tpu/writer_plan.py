"""Recon-plan IR + executor: the writer backbone.

Reference parity: src/writer.c:866 writer_create_plan (plan flavors
src/sections.h:475-487: TXTHEADER / FULL_VB / RANGE / INTERLEAVE /
DOWNSAMPLE / END_OF_VB) executed by one writer loop (writer_main_loop
:1203). This engine's plan is a small list of typed items produced by
`build_plan` from the output flags and *edited* (trimmed VBs, ranges,
steps) before execution — filters that the reference implements by plan
editing (--head/--tail/--lines/--downsample/--regions VB skipping) become
plan edits here too; per-record predicates (--grep/--qnames/--bases, the
vb->drop_curr_line role) are applied by the executor.

Multi-host PIZ assembly and ordered multi-component output hang off this
same IR: a plan is data, so it can be sliced per worker and the writer
stays a dumb ordered consumer.
"""

from dataclasses import dataclass

import numpy as np

# plan item kinds
TXTHEADER = "txthdr"      # emit component's txt header
VB_RANGE = "vb"           # records [start, end) step `step` of one VB
INTERLEAVE = "ilv"        # alternate records of (vb, comp 0) and (vb, comp 1)
DRAIN_VB = "drain"        # consume a skipped VB's gencomp queue share


@dataclass
class PlanItem:
    kind: str
    vb_i: int = 0
    comp_i: int = 0
    start: int = 0            # record index within the VB
    end: int | None = None    # exclusive; None = to VB end
    step: int = 1             # downsample stride (on raw record ordinals)
    phase: int = 0            # stride phase carried across VBs


def records_of(buf: bytes, lines_per_rec: int):
    """Split reconstructed text into records (vectorized newline scan).
    Returns (starts, ends) byte offsets per record."""
    a = np.frombuffer(buf, np.uint8)
    nl = np.nonzero(a == ord("\n"))[0]
    starts = np.concatenate([[0], nl[:-1] + 1]) if nl.shape[0] else \
        np.zeros(1 if buf else 0, np.int64)
    ends = nl + 1
    if buf and (nl.shape[0] == 0 or nl[-1] != len(buf) - 1):
        starts = np.concatenate(
            [starts, [nl[-1] + 1 if nl.shape[0] else 0]])
        ends = np.concatenate([ends, [len(buf)]])
    starts = starts[:ends.shape[0]]
    nrec = starts.shape[0] // lines_per_rec
    if lines_per_rec == 1:
        return starts, ends
    return (starts[::lines_per_rec][:nrec],
            ends[lines_per_rec - 1::lines_per_rec][:nrec])


def build_plan(pr, comp_i: int = 0, with_header: bool = True,
               regions=None, ra=None):
    """Full-file plan: header + every VB, with --regions VB skipping
    (random-access index, src/sections.h:536-541) folded in as plan edits
    (dropped VBs become DRAIN_VB so gencomp queues stay in step)."""
    plan = []
    if with_header:
        plan.append(PlanItem(TXTHEADER, comp_i=comp_i))
    comps = pr.components()
    nvb = comps[comp_i].get("num_vbs", pr.num_vbs()) \
        if comp_i < len(comps) else pr.num_vbs()
    for vb_i in range(1, nvb + 1):
        if regions is not None and ra is not None:
            from . import regions as regions_mod
            ents = ra.get(f"{comp_i}:{vb_i}")
            if ents is not None and not any(
                    regions_mod.regions_overlap(regions, c, lo, hi)
                    for (c, lo, hi) in ents):
                plan.append(PlanItem(DRAIN_VB, vb_i=vb_i, comp_i=comp_i))
                continue
        plan.append(PlanItem(VB_RANGE, vb_i=vb_i, comp_i=comp_i))
    return plan


def build_interleave_plan(pr):
    """Paired archive: records alternate R1/R2 per VB (the reference's
    PLAN_INTERLEAVE flavor)."""
    plan = []
    for vb_i in range(1, pr.num_vbs() + 1):
        plan.append(PlanItem(INTERLEAVE, vb_i=vb_i))
    return plan


def edit_lines_range(plan, first: int, last: int, counts):
    """--lines=first-last (1-based inclusive) as a plan trim. `counts` maps
    plan index -> record count of that VB (None = unknown, keep whole)."""
    out = []
    seen = 0
    for i, it in enumerate(plan):
        if it.kind != VB_RANGE:
            out.append(it)
            continue
        cnt = counts[i]
        if cnt is None:
            out.append(it)
            continue
        lo, hi = seen + 1, seen + cnt   # 1-based record ordinals of this VB
        seen += cnt
        if hi < first or lo > last:
            it = PlanItem(DRAIN_VB, vb_i=it.vb_i, comp_i=it.comp_i)
            out.append(it)
            continue
        s = max(first - lo, 0)
        e = cnt - max(hi - last, 0)
        out.append(PlanItem(VB_RANGE, vb_i=it.vb_i, comp_i=it.comp_i,
                            start=s, end=e if e < cnt else None,
                            step=it.step, phase=it.phase))
    return out


def edit_downsample(plan, k: int, counts):
    """--downsample=k: keep every k-th record (raw ordinals), carried
    across VBs via the per-item phase."""
    seen = 0
    for i, it in enumerate(plan):
        if it.kind != VB_RANGE:
            continue
        it.step = k
        it.phase = seen % k
        cnt = counts[i]
        seen += cnt if cnt is not None else 0
    return plan


def edit_tail(plan, k: int, counts):
    """--tail=k: keep only the last k records (plan trimmed from the
    front) — requires known counts (no per-record predicates)."""
    total = sum(c for i, c in enumerate(counts)
                if c is not None and plan[i].kind == VB_RANGE)
    first = max(total - k, 0) + 1
    return edit_lines_range(plan, first, 1 << 62, counts)


def vb_record_counts(pr, plan):
    """Reconstructed record count per plan item (from VB headers; gencomp
    MAIN VBs add their deported-line share, src/gencomp_piz.c)."""
    from .format import sections as fmt
    counts = []
    has_gc = pr.ensure_gencomp()
    for it in plan:
        if it.kind != VB_RANGE:
            counts.append(None)
            continue
        payload, _ = pr.zr.read_one(fmt.SEC_VB_HEADER, vb_i=it.vb_i,
                                    comp_i=it.comp_i)
        if payload is None and it.comp_i == 0:
            payload, _ = pr.zr.read_one(fmt.SEC_VB_HEADER, vb_i=it.vb_i)
        if payload is None:
            counts.append(None)
            continue
        hdr = fmt.vbhdr_parse(payload)
        # vb_hdr["n"] already counts RECORDS (a FASTQ "line" is the 4-line
        # read, matching the datatype's num_lines semantics)
        n = hdr["n"]
        if has_gc and it.comp_i == 0:
            with pr.io_lock:
                sec = pr._load_ctx_sections(it.vb_i, 0, ["GPPOS", "GCPOS"])
            for nm in ("GPPOS", "GCPOS"):
                loc = sec.get(nm, {}).get("local")
                if loc is not None:
                    n += loc[0].shape[0]
        counts.append(n)
    return counts


def execute_plan(pr, plan, out, lines_per_rec: int = 1, predicate=None,
                 head: int | None = None, tail: int | None = None,
                 count_only: bool = False, line_filter=None,
                 no_header: bool = False, transform=None):
    """The writer loop (src/writer.c:1203 writer_main_loop role): consume
    plan items in order, apply per-record predicates, honor the head
    budget, buffer for tail-after-predicates, count or emit. `transform`
    maps each emitted record (the genocat projection role: --seq-only /
    --qual-only, flags.h)."""
    emitted = 0
    tail_buf = []
    from .utils import ragged

    def emit(rec: bytes) -> bool:
        """Returns False when the head budget is exhausted."""
        nonlocal emitted
        if transform is not None:
            rec = transform(rec)
            if rec is None:
                return True
        if tail is not None:
            tail_buf.append(rec)
            if len(tail_buf) > tail:
                tail_buf.pop(0)
            return True
        emitted += 1
        if not count_only:
            out.write(rec)
        return not (head and emitted >= head)

    stop = False
    for it in plan:
        if stop:
            if it.kind == VB_RANGE or it.kind == DRAIN_VB:
                continue
        if it.kind == TXTHEADER:
            hdr = pr.txt_header(it.comp_i)
            if hdr and not no_header and not count_only:
                out.write(hdr)
        elif it.kind == DRAIN_VB:
            if pr.ensure_gencomp():
                pr.drain_vb_gencomp(it.vb_i)
        elif it.kind == INTERLEAVE:
            bufs = [pr.read_vb(it.vb_i, 0), pr.read_vb(it.vb_i, 1)]
            cols = []
            for b in bufs:
                st, en = records_of(b, lines_per_rec)
                a = np.frombuffer(b, np.uint8)
                cols.append(ragged.gather_ranges(a, st, en - st))
            merged = ragged.interleave(cols)
            if not count_only:
                out.write(merged.data.tobytes())
            emitted += len(cols[0]) + len(cols[1])
        elif it.kind == VB_RANGE:
            buf = pr.read_vb(it.vb_i, it.comp_i)
            if line_filter is not None:
                buf = line_filter(buf)
            whole = (it.start == 0 and it.end is None and it.step == 1
                     and predicate is None and head is None
                     and tail is None and not count_only
                     and line_filter is None and transform is None)
            if whole:
                out.write(buf)
                continue
            starts, ends = records_of(buf, lines_per_rec)
            nrec = starts.shape[0]
            end = nrec if it.end is None else min(it.end, nrec)
            for r in range(it.start, end):
                if it.step > 1 and (r + it.phase) % it.step != 0:
                    continue
                rec = buf[starts[r]:ends[r]]
                if predicate is not None and not predicate(rec):
                    continue
                if not emit(rec):
                    stop = True
                    break
    for rec in tail_buf:
        if not count_only:
            out.write(rec)
    if count_only:
        out.write(b"%d\n" % (len(tail_buf) if tail is not None else emitted))
    return emitted
