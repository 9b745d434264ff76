"""Device functions of the port: each has a plain PyTorch version and a
wrapper that launches a hand-written CUDA kernel on CUDA tensors."""
from .encode import (extract_kmers, extract_kmers_packed, unpack_wire,
                     wire_width)
from .lookup import (bucket_sort, bucket_sort_plain, fuse_stash,
                     fuse_table, hash32, lookup_q8, lookup_q8_plain,
                     lookup_q8_sorted, lookup_q8_sorted_plain, lookup_q12,
                     lookup_q12_plain, lookup_q12_sorted,
                     lookup_q12_sorted_plain, lookup_std, lookup_std_owned,
                     lookup_std_plain, lookup_std_sorted,
                     lookup_std_sorted_plain, mix32)
from .gather import (block_copy, row_gather, row_gather_direct,
                     row_gather_plain)
from .minimize import (extract_probes, extract_probes_packed,
                       extract_probes_plain, select_minimizers)
from .route import (route_bin, route_bin_plain, route_restore,
                    route_restore_plain)
from .rowprobe import (rowprobe_onehot, rowprobe_onehot_plain,
                       rowprobe_plain, rowprobe_route, rowprobe_route_plain,
                       rowprobe_routed_plain, rowprobe_smem)
from .score import (general_reads, lca_lift, lca_lift_plain,
                    lca_pairs_plain, merge_multik, merge_multik_plain,
                    pscore_ranked_plain,
                    reset_general_reads, score_plan, score_ranked,
                    score_reads_plain, score_reads_taxon,
                    score_reads_taxon_plain, score_reads_tin,
                    score_reads_tin_plain, score_winners,
                    score_winners_plain)

# The kernel wrappers, whose `launches` attribute counts kernel launches
# (lca_lift and merge_multik: the scorer launches whose tail lifts or
# merges).
KERNELS = {"extract_probes": extract_probes, "lookup_q8": lookup_q8,
           "score_tin": score_reads_tin, "lookup_std": lookup_std,
           "score_taxon": score_reads_taxon, "lca_lift": lca_lift,
           "lookup_q12": lookup_q12, "merge_multik": merge_multik,
           "score_ranked": score_ranked,
           "extract_packed": extract_probes_packed,
           "bucket_sort": bucket_sort, "lookup_q8_sorted": lookup_q8_sorted,
           "lookup_q12_sorted": lookup_q12_sorted,
           "lookup_std_sorted": lookup_std_sorted,
           "lookup_std_owned": lookup_std_owned, "route_bin": route_bin,
           "route_restore": route_restore,
           "rowprobe_route": rowprobe_route, "rowprobe_smem": rowprobe_smem,
           "rowprobe_onehot": rowprobe_onehot, "row_gather": row_gather,
           "row_gather_direct": row_gather_direct, "block_copy": block_copy}


def kernel_launches() -> dict:
    """Launch count of every kernel wrapper, by kernel name."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_kernel_launches() -> None:
    """Set every launch count to 0, and the scorer's general-branch
    counts (:func:`general_reads`) with them."""
    for fn in KERNELS.values():
        fn.launches = 0
    reset_general_reads()


__all__ = ["KERNELS", "block_copy", "bucket_sort", "bucket_sort_plain",
           "extract_kmers",
           "extract_kmers_packed", "extract_probes", "extract_probes_packed",
           "extract_probes_plain", "fuse_stash", "fuse_table", "general_reads",
           "hash32",
           "kernel_launches", "lca_lift", "lca_lift_plain",
           "lca_pairs_plain", "lookup_q8", "lookup_q8_plain",
           "lookup_q8_sorted", "lookup_q8_sorted_plain", "lookup_q12",
           "lookup_q12_plain", "lookup_q12_sorted", "lookup_q12_sorted_plain",
           "lookup_std", "lookup_std_owned", "lookup_std_plain",
           "lookup_std_sorted", "lookup_std_sorted_plain", "merge_multik",
           "merge_multik_plain", "mix32",
           "pscore_ranked_plain", "reset_general_reads",
           "reset_kernel_launches", "route_bin",
           "route_bin_plain", "route_restore", "route_restore_plain",
           "row_gather", "row_gather_direct", "row_gather_plain",
           "rowprobe_onehot", "rowprobe_onehot_plain", "rowprobe_plain",
           "rowprobe_route", "rowprobe_route_plain", "rowprobe_routed_plain",
           "rowprobe_smem", "score_plan", "score_ranked",
           "score_reads_plain", "score_reads_taxon",
           "score_reads_taxon_plain", "score_reads_tin",
           "score_reads_tin_plain", "score_winners", "score_winners_plain",
           "select_minimizers", "unpack_wire", "wire_width"]
