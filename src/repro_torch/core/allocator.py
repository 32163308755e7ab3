"""Page/pool model: object->page packing and the short-lived reserved pool.

An accelerator's buffers are object-granular, so page-level false sharing
(paper Obs. 3) does not exist at runtime on the card. This module *models*
the paper's three allocation regimes over a profiled trace so the page-grain
baselines (IAL/LRU) and the Fig. 11 ablations are reproducible:

  - "original":  bump allocation in birth order; small objects share pages
                 (false sharing present — pages mix hot and cold objects).
  - "profiled":  one object per page (the paper's profiling-phase layout;
                 inflates footprint, Table 1/5).
  - "sentinel":  objects grouped by their (birth, death) access signature —
                 the paper's bit-string grouping — sorted by access count and
                 packed, eliminating false sharing.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from repro_torch.core.profiler import PAGE, DataObject, TraceProfile


@dataclass
class Page:
    pid: int
    objects: List[DataObject] = field(default_factory=list)
    used: int = 0

    @property
    def accesses(self):
        steps = set()
        for o in self.objects:
            steps.update(o.accesses)
        return sorted(steps)

    @property
    def birth(self) -> int:
        return min(o.birth for o in self.objects)

    @property
    def death(self) -> int:
        return max(o.death for o in self.objects)

    @property
    def bytes(self) -> int:
        return PAGE

    @property
    def long_lived(self) -> bool:
        return any(o.death - o.birth >= 2 for o in self.objects)


def pack_pages(objects: List[DataObject], mode: str) -> Tuple[List[Page], Dict[int, Page]]:
    """Returns (pages, obj_uid -> page). Large objects get exclusive pages."""
    pages: List[Page] = []
    omap: Dict[int, Page] = {}

    def new_page() -> Page:
        p = Page(len(pages))
        pages.append(p)
        return p

    def place_exclusive(o: DataObject):
        n = (o.size + PAGE - 1) // PAGE
        p = new_page()
        p.objects.append(o)
        p.used = o.size
        omap[o.uid] = p
        for _ in range(n - 1):  # tail pages of a multi-page object
            q = new_page()
            q.objects.append(o)
            q.used = PAGE
        return p

    if mode == "profiled":
        for o in objects:
            place_exclusive(o)
        return pages, omap

    if mode == "original":
        cur = None
        for o in sorted(objects, key=lambda o: (o.birth, o.uid)):
            if o.size >= PAGE:
                place_exclusive(o)
                continue
            if cur is None or cur.used + o.size > PAGE:
                cur = new_page()
            cur.objects.append(o)
            cur.used += o.size
            omap[o.uid] = cur
        return pages, omap

    if mode == "sentinel":
        groups = defaultdict(list)
        for o in objects:
            if o.size >= PAGE:
                place_exclusive(o)
            else:
                groups[(o.birth, o.death)].append(o)
        for _, objs in sorted(groups.items()):
            objs.sort(key=lambda o: o.reads)   # paper: increasing access count
            cur = None
            for o in objs:
                if cur is None or cur.used + o.size > PAGE:
                    cur = new_page()
                cur.objects.append(o)
                cur.used += o.size
                omap[o.uid] = cur
        return pages, omap

    raise ValueError(mode)


def footprint(pages: List[Page]) -> int:
    return len(pages) * PAGE


def profiling_overhead(profile: TraceProfile) -> dict:
    """Table 1 / Table 5 reproduction: footprint growth of one-object-per-page
    during the profiling step, and of small objects specifically."""
    objs = [o for o in profile.objects if o.kind == "activation"]
    small = [o for o in objs if o.small]
    orig_pages, _ = pack_pages(objs, "original")
    prof_pages, _ = pack_pages(objs, "profiled")
    return {
        "orig_bytes": footprint(orig_pages),
        "profiled_bytes": footprint(prof_pages),
        "small_obj_bytes": sum(o.size for o in small),
        "small_obj_profiled_bytes": len(small) * PAGE,
        "overhead_frac": footprint(prof_pages) / max(1, footprint(orig_pages)) - 1,
    }


def false_sharing_stats(profile: TraceProfile) -> dict:
    """Obs. 3: how many pages mix short-lived and long-lived objects under
    the original allocation."""
    objs = [o for o in profile.objects if o.kind == "activation"]
    pages, _ = pack_pages(objs, "original")
    shared = [p for p in pages if len(p.objects) > 1]
    mixed = [p for p in shared
             if any(o.lifetime <= 1 for o in p.objects)
             and any(o.lifetime >= 2 for o in p.objects)]
    return {"pages": len(pages), "shared_pages": len(shared),
            "false_shared_pages": len(mixed),
            "false_sharing_frac": len(mixed) / max(1, len(pages))}
