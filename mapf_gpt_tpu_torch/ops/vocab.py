"""Token vocabulary and context layout (the port's own copy of
``mapf_gpt_tpu/ops/vocab.py``; the two must stay equal, which
``tests/test_torch_maps.py`` checks).

Mirrors the reference vocabulary construction
(ref:dataset/tokenizer/tokenizer.py:31-47 and ref:mapf_gpt/observation_generator.cpp:321-350)
but expressed arithmetically so the encoding is a pure gather-free integer map
that runs on-device.

Vocabulary (67 tokens), in reference enumeration order:

====================  =========  ==========================================
ids                   count      tokens
====================  =========  ==========================================
0 .. 40               41         cost2go / coordinate values -20 .. +20
41                    1          -80  (unreachable / obstacle sentinel)
42                    1          -40  (clamped "far negative" sentinel)
43                    1          +40  (clamped "far positive" sentinel)
44 .. 49              6          actions 'n','w','u','d','l','r'
50 .. 65              16         greedy-action 4-bit masks '0000'..'1111'
66                    1          '!' padding / trash token
====================  =========  ==========================================

Context layout (ref:dataset/tokenizer/tokenizer.py:79-92): 121 cost2go tokens
(11x11 egocentric window, row-major), then NUM_NEIGHBORS=13 agent records of
10 tokens each (rel_pos_x, rel_pos_y, rel_goal_x, rel_goal_y, 5 previous
actions oldest-first, greedy next-action mask), then '!' padding to 256.
"""

# --- scalar config (reference defaults, ref:dataset/tokenizer/parameters.py) ---
C2G_LIMIT = 20          # cost2go_value_limit
C2G_RADIUS = 5          # cost2go_radius -> 11x11 window
AGENTS_RADIUS = 5       # Chebyshev neighborhood for agent records
NUM_NEIGHBORS = 13      # num_agents in a context (incl. self)
NUM_PREV_ACTIONS = 5
CONTEXT_SIZE = 256

# --- derived vocabulary ids ---
ID_COORD_ZERO = C2G_LIMIT            # value v in [-20, 20] -> id v + 20
ID_UNREACHABLE = 2 * C2G_LIMIT + 1   # 41: value -80 (= -4*limit)
ID_FAR_NEG = ID_UNREACHABLE + 1      # 42: value -40 (= -2*limit)
ID_FAR_POS = ID_UNREACHABLE + 2      # 43: value +40 (= +2*limit)
ID_ACTION_BASE = ID_FAR_POS + 1      # 44: 'n'; 'w'=45 'u'=46 'd'=47 'l'=48 'r'=49
ID_NEXT_ACTION_BASE = ID_ACTION_BASE + 6   # 50: greedy mask '0000'
ID_PAD = ID_NEXT_ACTION_BASE + 16    # 66: '!'
VOCAB_SIZE = ID_PAD + 1              # 67

# --- layout ---
C2G_WINDOW = 2 * C2G_RADIUS + 1                    # 11
C2G_TOKENS = C2G_WINDOW * C2G_WINDOW               # 121
AGENT_RECORD = 4 + NUM_PREV_ACTIONS + 1            # 10
AGENT_TOKENS = NUM_NEIGHBORS * AGENT_RECORD        # 130
TAIL_PAD = CONTEXT_SIZE - C2G_TOKENS - AGENT_TOKENS  # 5

# --- environment action space (ref:dataset/tokenizer/generate_observations.py:10-17) ---
# action ids: 0=wait, 1=up(-1,0), 2=down(+1,0), 3=left(0,-1), 4=right(0,+1)
NUM_ACTIONS = 5
MOVES = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
# greedy next-action bit order: u, d, l, r (MSB first in the 4-bit string,
# ref:mapf_gpt/observation_generator.cpp:412-430)
GREEDY_MOVES = ((-1, 0), (1, 0), (0, -1), (0, 1))

# history symbols stored compactly as 0..5: 0='n', 1='w', 2='u', 3='d', 4='l', 5='r'
# (token id = ID_ACTION_BASE + symbol). An executed env action a in 0..4 maps to
# symbol a+1; "no action yet" (-1) maps to 'n' = 0
# (ref:mapf_gpt/observation_generator.cpp:442-462).
HIST_N = 0


def coord_token(v: int) -> int:
    """Host-side scalar version of the coordinate/cost2go value -> id map."""
    if v == -4 * C2G_LIMIT:
        return ID_UNREACHABLE
    if v == -2 * C2G_LIMIT:
        return ID_FAR_NEG
    if v == 2 * C2G_LIMIT:
        return ID_FAR_POS
    assert -C2G_LIMIT <= v <= C2G_LIMIT, v
    return v + ID_COORD_ZERO
