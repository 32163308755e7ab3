"""The port's ``PageTable`` under the reference's sharing property
(``tests/test_properties.py::test_page_table_sharing_invariants``), with
Hypothesis, and ROADMAP R11 pinned: the reference keeps its cold-twin memo
through a write in place to either page of a memoized pair, so a later
sharer's demotion reuses a twin that no longer holds its data; the port
drops the memo there.  No engine path writes a twin in place, so the
engines' pages and counters are the same in both packages."""
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.models.kvcache import PageTable as RefPageTable
from repro_torch.models.kvcache import PageTable

SLOTS, NP, PG = 4, 4, 8


@st.composite
def page_table_ops(draw, max_ops=40):
    """The reference property's legal op programs: refill with a fresh
    request, share a prefix from a donor, write (CoW when shared), demote
    the boundary page, free."""
    return [(draw(st.sampled_from(["refill", "share", "write", "demote",
                                   "free"])),
             draw(st.integers(0, SLOTS - 1)), draw(st.integers(0, NP - 1)))
            for _ in range(draw(st.integers(1, max_ops)))]


def run_program(table_cls, ops):
    """Drive ``ops`` on a fresh table as the reference's property does,
    with its checks after every op: ``check()``, no negative refcount,
    the cold prefix in tokens, and every slot's logical content (who
    wrote each page) through CoW, twin-deduped demotion and frees.
    Returns the first failed check's message, or None."""
    pt = table_cls(SLOTS, NP, PG)
    hot, cold = {}, {}                       # phys -> content token
    expect = [[None] * NP for _ in range(SLOTS)]

    def store(s, i):
        return cold if pt.tier[s][i] == 1 else hot

    for stamp, (op, s, i) in enumerate(ops, 1):
        if op == "refill":
            pt.free_slot(s)
            expect[s] = [None] * NP
            for j in range(i + 1):
                if not pt.hot_free:
                    break
                pt.alloc(s, 0)
                hot[pt.table[s][j]] = expect[s][j] = ("w", s, stamp, j)
        elif op == "share":
            donor = (s + 1) % SLOTS
            if pt.n_pages[s] == 0 and pt.n_pages[donor] > 0:
                n = min(i + 1, pt.n_pages[donor])
                pt.share(s, donor, n)
                expect[s] = list(expect[donor][:n]) + [None] * (NP - n)
        elif op == "write" and i < pt.n_pages[s]:
            r = pt.cow(s, i)
            if r is not None:                # the engine copies the page
                src, new, tier = r
                d = cold if tier == 1 else hot
                d[new] = d[src]
            store(s, i)[pt.table[s][i]] = expect[s][i] = ("w", s, stamp, i)
        elif op == "demote":
            b = pt.cold_pages(s)
            if b < pt.n_pages[s] and pt.cold_free:
                cold_phys, src, copied = pt.demote(s, b)
                if copied:
                    cold[cold_phys] = hot[src]
        elif op == "free":
            pt.free_slot(s)
            expect[s] = [None] * NP
        try:
            pt.check()
        except AssertionError as e:
            return f"op {stamp}: {e}"
        if any(r < 0 for r in pt.hot_ref + pt.cold_ref):
            return f"op {stamp}: negative refcount"
        for sl in range(SLOTS):
            if pt.cold_pages(sl) * PG != pt.cold_tokens(sl):
                return f"op {stamp}: cold tokens"
            for j in range(pt.n_pages[sl]):
                if expect[sl][j] is not None and \
                        store(sl, j)[pt.table[sl][j]] != expect[sl][j]:
                    return (f"op {stamp}: slot {sl} page {j} lost its "
                            f"content through share/CoW/demote")
    return None


@given(page_table_ops())
@settings(max_examples=60, deadline=None)
def test_page_table_sharing_invariants(ops):
    """The reference's property on the port's table: every check holds
    after every op of every drawn program."""
    assert run_program(PageTable, ops) is None


# ROADMAP R11's program: slot 1 fills a page, slot 0 shares it, slot 0
# demotes it (a cold twin, memoized for the hot page's other sharer),
# slot 0 writes its cold page in place, slot 1 demotes the hot page
R11 = [("refill", 1, 0), ("share", 0, 0), ("demote", 0, 0),
       ("write", 0, 0), ("demote", 1, 0)]
# the same through a write in place to the hot page: slot 0 demotes, slot
# 1 (now the hot page's only holder) writes it, then demotes it
R11_HOT = [("refill", 1, 0), ("share", 0, 0), ("demote", 0, 0),
           ("write", 1, 0), ("demote", 1, 0)]


def test_r11_pinned_beside_the_reference():
    """On R11's programs the reference hands slot 1 the twin that slot
    0's write changed (or that its own write left stale) and loses slot
    1's content at the last op; the port forgets the pair at the write,
    copies slot 1's page at its demotion, and keeps every check."""
    for program in (R11, R11_HOT):
        assert run_program(RefPageTable, program) == \
            "op 5: slot 1 page 0 lost its content through share/CoW/demote"
        assert run_program(PageTable, program) is None
    port = PageTable(SLOTS, NP, PG)
    port.alloc(1, 0)
    port.share(0, 1, 1)
    port.demote(0, 0)
    assert port.cold_twin                    # memoized for slot 1
    assert port.cow(0, 0) is None            # an in-place write
    assert port.cold_twin == {} and port._twin_of == {}
    assert port.demote(1, 0)[2] is True      # slot 1 copies its own page
