"""GroupSequence.txt parser (a copy of the JAX package's
multisession/group_sequence.py; reference loop_detect.py:160-191).

Format: numbered blocks; each block holds frame-index lists, optionally
tagged [Order] / [ReverseOrder] (reversed lists are flipped on read).
"""
import re


def parse_group_sequence(path):
    data = {}
    with open(path, "r") as f:
        lines = f.readlines()

    current = None
    for line in lines:
        if re.match(r"^\d+$", line.strip()):
            current = int(line.strip())
            data[current] = []
            continue
        m = re.search(r": ([\d\s]+)\s*\[(Order|ReverseOrder)\]\s*", line)
        if m:
            numbers = list(map(int, m.group(1).split()))
            if m.group(2) == "ReverseOrder":
                numbers = numbers[::-1]
            data[current].append(numbers)
            continue
        m = re.search(r": ([\d\s]+)\s*$", line)
        if m:
            data[current].append(list(map(int, m.group(1).split())))
    return data
