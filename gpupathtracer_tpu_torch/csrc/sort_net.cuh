// The child-order networks of csrc/bvh_walk.cuh sort_children, one per
// node arity A (GPT_ARITY, 2 to 16): the compare-exchange pairs of the JAX
// kernel's _sort_net(A) (gpupathtracer_tpu/ops/pallas_traverse.py:46-69),
// Batcher's odd-even merge sort trimmed to A keys, and at A = 8 the
// hand-kept 19 pairs of its _NET8. Each sorts every input of A keys
// (tests/test_torch_walk_order.py reads the pairs from this file, checks
// them against the JAX kernel's and by the 0-1 principle). Only the
// network of the build's arity is compiled.

#pragma once

#if GPT_ARITY == 2
// child-order network, arity 2
#define GPT_CHILD_NET_SIZE 1
#define GPT_CHILD_NET \
  {{0, 1}}
#elif GPT_ARITY == 3
// child-order network, arity 3
#define GPT_CHILD_NET_SIZE 3
#define GPT_CHILD_NET \
  {{0, 1}, {0, 2}, {1, 2}}
#elif GPT_ARITY == 4
// child-order network, arity 4
#define GPT_CHILD_NET_SIZE 5
#define GPT_CHILD_NET \
  {{0, 1}, {2, 3}, {0, 2}, {1, 3}, {1, 2}}
#elif GPT_ARITY == 5
// child-order network, arity 5
#define GPT_CHILD_NET_SIZE 9
#define GPT_CHILD_NET \
  {{0, 1}, {2, 3}, {0, 2}, {1, 3}, {1, 2}, {0, 4}, {2, 4}, {1, 2}, {3, 4}}
#elif GPT_ARITY == 6
// child-order network, arity 6
#define GPT_CHILD_NET_SIZE 12
#define GPT_CHILD_NET \
  {{0, 1}, {2, 3}, {4, 5}, {0, 2}, {1, 3}, {1, 2}, {0, 4}, {1, 5}, {2, 4}, \
   {3, 5}, {1, 2}, {3, 4}}
#elif GPT_ARITY == 7
// child-order network, arity 7
#define GPT_CHILD_NET_SIZE 16
#define GPT_CHILD_NET \
  {{0, 1}, {2, 3}, {4, 5}, {0, 2}, {1, 3}, {4, 6}, {1, 2}, {5, 6}, {0, 4}, \
   {1, 5}, {2, 6}, {2, 4}, {3, 5}, {1, 2}, {3, 4}, {5, 6}}
#elif GPT_ARITY == 8
// child-order network, arity 8
#define GPT_CHILD_NET_SIZE 19
#define GPT_CHILD_NET \
  {{0, 1}, {2, 3}, {4, 5}, {6, 7}, {0, 2}, {1, 3}, {4, 6}, {5, 7}, {1, 2}, \
   {5, 6}, {0, 4}, {3, 7}, {1, 5}, {2, 6}, {1, 4}, {3, 6}, {2, 4}, {3, 5}, \
   {3, 4}}
#elif GPT_ARITY == 9
// child-order network, arity 9
#define GPT_CHILD_NET_SIZE 28
#define GPT_CHILD_NET \
  {{0, 1}, {2, 3}, {4, 5}, {6, 7}, {0, 2}, {1, 3}, {4, 6}, {5, 7}, {1, 2}, \
   {5, 6}, {0, 4}, {1, 5}, {2, 6}, {3, 7}, {2, 4}, {3, 5}, {1, 2}, {3, 4}, \
   {5, 6}, {0, 8}, {4, 8}, {2, 4}, {3, 5}, {6, 8}, {1, 2}, {3, 4}, {5, 6}, \
   {7, 8}}
#elif GPT_ARITY == 10
// child-order network, arity 10
#define GPT_CHILD_NET_SIZE 32
#define GPT_CHILD_NET \
  {{0, 1}, {2, 3}, {4, 5}, {6, 7}, {8, 9}, {0, 2}, {1, 3}, {4, 6}, {5, 7}, \
   {1, 2}, {5, 6}, {0, 4}, {1, 5}, {2, 6}, {3, 7}, {2, 4}, {3, 5}, {1, 2}, \
   {3, 4}, {5, 6}, {0, 8}, {1, 9}, {4, 8}, {5, 9}, {2, 4}, {3, 5}, {6, 8}, \
   {7, 9}, {1, 2}, {3, 4}, {5, 6}, {7, 8}}
#elif GPT_ARITY == 11
// child-order network, arity 11
#define GPT_CHILD_NET_SIZE 38
#define GPT_CHILD_NET \
  {{0, 1}, {2, 3}, {4, 5}, {6, 7}, {8, 9}, {0, 2}, {1, 3}, {4, 6}, {5, 7}, \
   {8, 10}, {1, 2}, {5, 6}, {9, 10}, {0, 4}, {1, 5}, {2, 6}, {3, 7}, {2, 4}, \
   {3, 5}, {1, 2}, {3, 4}, {5, 6}, {9, 10}, {0, 8}, {1, 9}, {2, 10}, {4, 8}, \
   {5, 9}, {6, 10}, {2, 4}, {3, 5}, {6, 8}, {7, 9}, {1, 2}, {3, 4}, {5, 6}, \
   {7, 8}, {9, 10}}
#elif GPT_ARITY == 12
// child-order network, arity 12
#define GPT_CHILD_NET_SIZE 42
#define GPT_CHILD_NET \
  {{0, 1}, {2, 3}, {4, 5}, {6, 7}, {8, 9}, {10, 11}, {0, 2}, {1, 3}, {4, 6}, \
   {5, 7}, {8, 10}, {9, 11}, {1, 2}, {5, 6}, {9, 10}, {0, 4}, {1, 5}, {2, 6}, \
   {3, 7}, {2, 4}, {3, 5}, {1, 2}, {3, 4}, {5, 6}, {9, 10}, {0, 8}, {1, 9}, \
   {2, 10}, {3, 11}, {4, 8}, {5, 9}, {6, 10}, {7, 11}, {2, 4}, {3, 5}, \
   {6, 8}, {7, 9}, {1, 2}, {3, 4}, {5, 6}, {7, 8}, {9, 10}}
#elif GPT_ARITY == 13
// child-order network, arity 13
#define GPT_CHILD_NET_SIZE 48
#define GPT_CHILD_NET \
  {{0, 1}, {2, 3}, {4, 5}, {6, 7}, {8, 9}, {10, 11}, {0, 2}, {1, 3}, {4, 6}, \
   {5, 7}, {8, 10}, {9, 11}, {1, 2}, {5, 6}, {9, 10}, {0, 4}, {1, 5}, {2, 6}, \
   {3, 7}, {8, 12}, {2, 4}, {3, 5}, {10, 12}, {1, 2}, {3, 4}, {5, 6}, \
   {9, 10}, {11, 12}, {0, 8}, {1, 9}, {2, 10}, {3, 11}, {4, 12}, {4, 8}, \
   {5, 9}, {6, 10}, {7, 11}, {2, 4}, {3, 5}, {6, 8}, {7, 9}, {10, 12}, \
   {1, 2}, {3, 4}, {5, 6}, {7, 8}, {9, 10}, {11, 12}}
#elif GPT_ARITY == 14
// child-order network, arity 14
#define GPT_CHILD_NET_SIZE 53
#define GPT_CHILD_NET \
  {{0, 1}, {2, 3}, {4, 5}, {6, 7}, {8, 9}, {10, 11}, {12, 13}, {0, 2}, \
   {1, 3}, {4, 6}, {5, 7}, {8, 10}, {9, 11}, {1, 2}, {5, 6}, {9, 10}, {0, 4}, \
   {1, 5}, {2, 6}, {3, 7}, {8, 12}, {9, 13}, {2, 4}, {3, 5}, {10, 12}, \
   {11, 13}, {1, 2}, {3, 4}, {5, 6}, {9, 10}, {11, 12}, {0, 8}, {1, 9}, \
   {2, 10}, {3, 11}, {4, 12}, {5, 13}, {4, 8}, {5, 9}, {6, 10}, {7, 11}, \
   {2, 4}, {3, 5}, {6, 8}, {7, 9}, {10, 12}, {11, 13}, {1, 2}, {3, 4}, \
   {5, 6}, {7, 8}, {9, 10}, {11, 12}}
#elif GPT_ARITY == 15
// child-order network, arity 15
#define GPT_CHILD_NET_SIZE 59
#define GPT_CHILD_NET \
  {{0, 1}, {2, 3}, {4, 5}, {6, 7}, {8, 9}, {10, 11}, {12, 13}, {0, 2}, \
   {1, 3}, {4, 6}, {5, 7}, {8, 10}, {9, 11}, {12, 14}, {1, 2}, {5, 6}, \
   {9, 10}, {13, 14}, {0, 4}, {1, 5}, {2, 6}, {3, 7}, {8, 12}, {9, 13}, \
   {10, 14}, {2, 4}, {3, 5}, {10, 12}, {11, 13}, {1, 2}, {3, 4}, {5, 6}, \
   {9, 10}, {11, 12}, {13, 14}, {0, 8}, {1, 9}, {2, 10}, {3, 11}, {4, 12}, \
   {5, 13}, {6, 14}, {4, 8}, {5, 9}, {6, 10}, {7, 11}, {2, 4}, {3, 5}, \
   {6, 8}, {7, 9}, {10, 12}, {11, 13}, {1, 2}, {3, 4}, {5, 6}, {7, 8}, \
   {9, 10}, {11, 12}, {13, 14}}
#elif GPT_ARITY == 16
// child-order network, arity 16
#define GPT_CHILD_NET_SIZE 63
#define GPT_CHILD_NET \
  {{0, 1}, {2, 3}, {4, 5}, {6, 7}, {8, 9}, {10, 11}, {12, 13}, {14, 15}, \
   {0, 2}, {1, 3}, {4, 6}, {5, 7}, {8, 10}, {9, 11}, {12, 14}, {13, 15}, \
   {1, 2}, {5, 6}, {9, 10}, {13, 14}, {0, 4}, {1, 5}, {2, 6}, {3, 7}, \
   {8, 12}, {9, 13}, {10, 14}, {11, 15}, {2, 4}, {3, 5}, {10, 12}, {11, 13}, \
   {1, 2}, {3, 4}, {5, 6}, {9, 10}, {11, 12}, {13, 14}, {0, 8}, {1, 9}, \
   {2, 10}, {3, 11}, {4, 12}, {5, 13}, {6, 14}, {7, 15}, {4, 8}, {5, 9}, \
   {6, 10}, {7, 11}, {2, 4}, {3, 5}, {6, 8}, {7, 9}, {10, 12}, {11, 13}, \
   {1, 2}, {3, 4}, {5, 6}, {7, 8}, {9, 10}, {11, 12}, {13, 14}}
#endif
