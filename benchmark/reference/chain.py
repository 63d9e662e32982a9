"""The plain reference of the dev chain's balances: what a run of blocks
must leave, by the arithmetic of the transactions it sent (imports
nothing).

Each block pays the validator the reward treasury // reward_ratio out of
the treasury; the validator hands 5, 5 and 15 % of it (each rounded down
to whole percents) to the worker who proves the deposit, withdraw and
update batches, on L1, and deposits the rest into its MPN account.  Odd
blocks move each user's deposit from L1 into the MPN; even blocks move
user i's payment to user i + 1 and its fee out of its MPN account, and
each withdrawer's withdrawal back to L1.  Each block raises the MPN
contract's height by one.
"""

from __future__ import annotations

WORK_PERCENT = (5, 5, 15)


def expected_states(n_users: int, l1_funds: int, treasury: int,
                    reward_ratio: int, sent: list) -> list:
    """The state after each block of `sent` (one dict per block, as
    `DevChain.sent` notes them)."""
    mpn, l1 = [0] * n_users, [l1_funds] * n_users
    validator = worker = 0
    out = []
    for k, block in enumerate(sent):
        reward = treasury // reward_ratio
        treasury -= reward
        work = sum(reward // 100 * p for p in WORK_PERCENT)
        validator += reward - work
        worker += work
        if "deposit" in block:
            for i, a in enumerate(block["deposit"]):
                mpn[i] += a
                l1[i] -= a
        else:
            for i, w in enumerate(block["withdraw"]):
                mpn[i] -= w
                l1[i] += w
            for i, (pay, fee) in enumerate(zip(block["pay"], block["fee"])):
                mpn[i] -= pay + fee
                mpn[(i + 1) % n_users] += pay
        out.append({"mpn": list(mpn), "l1": list(l1),
                    "validator_mpn": validator, "worker_l1": worker,
                    "contract_height": k + 2})
    return out


def mismatches(state: dict, want: dict) -> int:
    """How many of the tracked balances and heights differ."""
    n = 0
    for key, v in want.items():
        got = state[key]
        if isinstance(v, list):
            n += sum(a != b for a, b in zip(got, v)) + abs(len(got) - len(v))
        else:
            n += got != v
    return n
