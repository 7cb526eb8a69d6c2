"""An in-place accum_stats (the port's form) that overwrites, drops,
double-folds and double-writes fields."""


def accum_stats(s, st, out, walk_res):
    miss2 = out["l2_tlb"].need
    s.n_used.add_(out["l1_tlb"].hit.int())           # clean
    s.n_overwrite.copy_(miss2.int())                 # C005: not added to
    s.n_shared.add_(out["l1_tlb"].hit.int() + miss2.int())  # C006
    s.n_twice.add_(1)                                # C005: folded twice
    s.n_twice.add_(1)
    b = out["restseg"].cycles                        # one writer each,
    s.hist_a[b] += 1                                 # though b is
    b = out["rev"].cycles                            # reassigned
    s.hist_b[b] += 1
    # n_orphan deliberately missing                  # C005: not folded
    return s
