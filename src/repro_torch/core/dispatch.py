"""Request dispatching (paper §4.2, Figure 3), in PyTorch.

The paper routes every request to the actor owning its hash tree, so no
tree is ever touched by two threads.  Here *dispatch* turns a flat
request batch into a dense (T, K) per-tree mailbox (sorted by tree,
ranked within tree); ``hash_tree.forest_insert_dispatched`` then applies
mailbox slot k to every tree at once, k = 0..K-1 in order — sequential
within a tree, parallel across trees.  Requests beyond a mailbox's
capacity K are flagged as *overflow* and re-submitted by the host in a
follow-up round.

The host-side ticket helpers for multi-client ingestion are plain
Python and are copied as they are.
"""
from __future__ import annotations

import collections

import torch

# ----------------------------------------------------------------------
# round flag word: one packed int32 per round, read back once by the host
# (see the JAX package's dispatch module for the meaning of each bit)
# ----------------------------------------------------------------------
FLAG_ANY_PENDING = 1
FLAG_NEED_SEAL = 2
FLAG_SNAPS_FULL = 4
FLAG_TOMBS_FULL = 8
FLAG_COLD_SPILL = 16
FLAG_COLD_FULL = 32
FLAG_COLD_MISS = 64
FLAG_STORE_FULL = 128

#: bit -> short name, the label vocabulary of the per-flag fire counters
FLAG_NAMES = {
    FLAG_ANY_PENDING: "pending",
    FLAG_NEED_SEAL: "need_seal",
    FLAG_SNAPS_FULL: "snaps_full",
    FLAG_TOMBS_FULL: "tombs_full",
    FLAG_COLD_SPILL: "cold_spill",
    FLAG_COLD_FULL: "cold_full",
    FLAG_COLD_MISS: "cold_miss",
    FLAG_STORE_FULL: "store_full",
}


def pack_round_flags(any_pending: torch.Tensor, need_seal: torch.Tensor,
                     snaps_full: torch.Tensor, tombs_full: torch.Tensor,
                     cold_spill: torch.Tensor | None = None,
                     cold_full: torch.Tensor | None = None,
                     cold_miss: torch.Tensor | None = None,
                     store_full: torch.Tensor | None = None) -> torch.Tensor:
    """Pack the round's booleans into one int32 flag word (on device)."""
    word = (any_pending.to(torch.int32) * FLAG_ANY_PENDING
            + need_seal.to(torch.int32) * FLAG_NEED_SEAL
            + snaps_full.to(torch.int32) * FLAG_SNAPS_FULL
            + tombs_full.to(torch.int32) * FLAG_TOMBS_FULL)
    for bit, flag in ((cold_spill, FLAG_COLD_SPILL),
                      (cold_full, FLAG_COLD_FULL),
                      (cold_miss, FLAG_COLD_MISS),
                      (store_full, FLAG_STORE_FULL)):
        if bit is not None:
            word = word + bit.to(torch.int32) * flag
    return word


def dispatch_to_trees(tree_ids: torch.Tensor, n_trees: int, capacity: int):
    """Build per-tree mailboxes from a flat request batch.

    tree_ids: (N,) ints in [0, n_trees); -1 marks an inactive row.

    Returns:
      mailbox_src: (T, K) int64 — request index filling slot k of tree t,
                   -1 for empty slots.
      overflow:    (N,) bool   — requests that did not fit this round.
    """
    n = tree_ids.shape[0]
    dev = tree_ids.device
    tree_ids = tree_ids.to(torch.int64)
    sort_key = torch.where(tree_ids >= 0, tree_ids, n_trees)  # invalid last
    sorted_tid, order = torch.sort(sort_key, stable=True)
    # rank within the tree's group = position - first occurrence
    first = torch.searchsorted(sorted_tid, sorted_tid, side="left")
    rank = torch.arange(n, device=dev) - first
    fits = (sorted_tid < n_trees) & (rank < capacity)
    # rows that do not fit land in the discard row n_trees, all writing -1
    dest_tree = torch.where(fits, sorted_tid, n_trees)
    dest_slot = torch.where(fits, rank, 0)
    mailbox = torch.full((n_trees + 1, capacity), -1, dtype=torch.int64,
                         device=dev)
    mailbox[dest_tree, dest_slot] = torch.where(fits, order, -1)
    overflow = torch.zeros(n, dtype=torch.bool, device=dev)
    overflow[order] = ~fits & (sorted_tid < n_trees)
    return mailbox[:n_trees], overflow


def gather_mailbox(mailbox_src: torch.Tensor, *arrays: torch.Tensor):
    """Materialise mailbox payloads: each (N, ...) array -> (T, K, ...).

    Empty slots keep index 0's payload; callers mask with the id array
    (convention: id == -1 for padding)."""
    safe = mailbox_src.clamp_min(0).reshape(-1)
    return tuple(a[safe].reshape(*mailbox_src.shape, *a.shape[1:])
                 for a in arrays)


def mailbox_ids(mailbox_src: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather ids with -1 preserved in empty slots (the padding marker)."""
    (g,) = gather_mailbox(mailbox_src, ids)
    return torch.where(mailbox_src >= 0, g, -1)


# ----------------------------------------------------------------------
# multi-client ingestion (paper §4.2's router thread, host-side)
# ----------------------------------------------------------------------
TICKET_CLIENT_SHIFT = 40          # tickets: (client_id << 40) | sequence


def client_ticket(client_id: int, seq: int) -> int:
    """Globally-unique ticket from a per-client sequence number."""
    assert 0 <= seq < (1 << TICKET_CLIENT_SHIFT)
    return (client_id << TICKET_CLIENT_SHIFT) | seq


def ticket_client(ticket: int) -> int:
    """Client id a ticket belongs to."""
    return ticket >> TICKET_CLIENT_SHIFT


def merge_client_queues(queues: list) -> list:
    """Round-robin merge of per-client request queues into one round,
    keeping every client's own FIFO order (tuple-opaque)."""
    out: list = []
    cursors = [0] * len(queues)
    remaining = sum(len(q) for q in queues)
    while remaining:
        for ci, q in enumerate(queues):
            if cursors[ci] < len(q):
                out.append(q[cursors[ci]])
                cursors[ci] += 1
                remaining -= 1
    return out


# ----------------------------------------------------------------------
# distributed routing: trees sharded over the ranks of a process group
# ----------------------------------------------------------------------
#: collectives the distributed path issues, by kind (read them around a
#: round to count its collectives; never reset here)
COLLECTIVES: collections.Counter = collections.Counter()


def owner_of_tree(tree_ids: torch.Tensor, n_trees: int,
                  n_shards: int) -> torch.Tensor:
    """Contiguous block ownership: shard s owns trees [s*T/S, (s+1)*T/S)."""
    per = n_trees // n_shards
    return torch.where(tree_ids >= 0, tree_ids // per, -1)


def all_to_all_route(bufs: list, group=None) -> list:
    """The actor message send: ONE ``all_to_all_single`` of several
    (S, K_i, C_i) int32 send mailboxes over ``group`` (row s goes to rank
    s), each packed with :func:`dispatch_to_trees` semantics (shard ==
    tree), so every route of a round's hop (and the acks back) shares one
    collective.  Returns each one's (S*K_i, C_i) receive block,
    sender-major.  Rows past a destination's capacity never leave the
    sender: its ``dispatch_to_trees`` overflow is the host's next round.
    (The JAX package's ``all_to_all_route`` packs one payload and sends it
    with its valid mask in two collectives.)"""
    import torch.distributed as dist

    S = bufs[0].shape[0]
    send = torch.cat([b.reshape(S, -1) for b in bufs], 1).contiguous()
    recv = torch.empty_like(send)
    COLLECTIVES["all_to_all"] += 1
    dist.all_to_all_single(recv, send, group=group)
    out, at = [], 0
    for b in bufs:
        w = b[0].numel()
        out.append(recv[:, at:at + w].reshape(S * b.shape[1], b.shape[2]))
        at += w
    return out
