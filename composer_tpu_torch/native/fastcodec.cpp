// Native accelerators for the host-side data path: the port's copy of
// composer_tpu/native/fastcodec.cpp.
//
// The device path is CUDA; this shared library accelerates the host runtime
// around it (the reference's host hot loops were pure Python: per-event
// struct.unpack in sequence.py:1686-1692 and a byte-at-a-time CRC would
// otherwise bottleneck TFRecord export):
//
//   * crc32c  — slice-by-8 Castagnoli CRC for TFRecord framing
//   * decode_event_ids — bulk (type, value) int16 pairs -> int32 vocab ids
//   * encode_event_pairs — bulk int32 vocab ids -> (type, value) int16 pairs
//   * composer_midi_parse / _fill / _release — the SMF parser behind
//     midi_io.read_note_arrays
//
// Built at first use with g++ -O3 -shared -fPIC -std=c++17 into build/native/
// and bound via ctypes (composer_tpu_torch/native/loader.py).

#include <cstdint>
#include <cstddef>

namespace {

constexpr uint32_t kCrc32cPoly = 0x82F63B78u;

struct Crc32cTables {
    uint32_t table[8][256];
    Crc32cTables() {
        for (uint32_t i = 0; i < 256; ++i) {
            uint32_t crc = i;
            for (int bit = 0; bit < 8; ++bit) {
                crc = (crc >> 1) ^ ((crc & 1) ? kCrc32cPoly : 0);
            }
            table[0][i] = crc;
        }
        for (uint32_t i = 0; i < 256; ++i) {
            uint32_t crc = table[0][i];
            for (int slice = 1; slice < 8; ++slice) {
                crc = table[0][crc & 0xFF] ^ (crc >> 8);
                table[slice][i] = crc;
            }
        }
    }
};

const Crc32cTables kTables;

}  // namespace

extern "C" {

// CRC32-C of `size` bytes. Slice-by-8: processes 8 bytes per iteration.
uint32_t composer_crc32c(const uint8_t* data, size_t size) {
    uint32_t crc = 0xFFFFFFFFu;
    const uint8_t* p = data;

    while (size >= 8) {
        uint32_t low;
        uint32_t high;
        __builtin_memcpy(&low, p, 4);
        __builtin_memcpy(&high, p + 4, 4);
        low ^= crc;
        crc = kTables.table[7][low & 0xFF] ^
              kTables.table[6][(low >> 8) & 0xFF] ^
              kTables.table[5][(low >> 16) & 0xFF] ^
              kTables.table[4][low >> 24] ^
              kTables.table[3][high & 0xFF] ^
              kTables.table[2][(high >> 8) & 0xFF] ^
              kTables.table[1][(high >> 16) & 0xFF] ^
              kTables.table[0][high >> 24];
        p += 8;
        size -= 8;
    }
    while (size--) {
        crc = kTables.table[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
    }
    return crc ^ 0xFFFFFFFFu;
}

// Event-id vocabulary layout (must match composer_tpu/midi/vocab.py):
//   NOTE_ON(1)->value, NOTE_OFF(2)->128+value, VELOCITY(4)->256+value,
//   TIME_SHIFT(3)->256+B+value-1, SUSTAIN_ON(5)/OFF(6)->256+B+M (+1).
// Returns 0 on success, 1 if an unknown event type was encountered.
int composer_decode_event_ids(
    const int16_t* pairs,   // interleaved (type, value), length 2*count
    size_t count,
    int32_t velocity_bins,
    int32_t max_time_steps,
    int32_t* out_ids) {
    const int32_t velocity_offset = 256;
    const int32_t time_shift_offset = 256 + velocity_bins;
    const int32_t sustain_on_id = time_shift_offset + max_time_steps;
    int status = 0;
    for (size_t i = 0; i < count; ++i) {
        const int16_t type = pairs[2 * i];
        const int16_t value = pairs[2 * i + 1];
        int32_t id;
        switch (type) {
            case 1: id = value; break;                            // NOTE_ON
            case 2: id = 128 + value; break;                      // NOTE_OFF
            case 3: id = time_shift_offset + value - 1; break;    // TIME_SHIFT
            case 4: id = velocity_offset + value; break;          // VELOCITY
            case 5: id = sustain_on_id; break;                    // SUSTAIN_ON
            case 6: id = sustain_on_id + 1; break;                // SUSTAIN_OFF
            default: id = 0; status = 1; break;
        }
        out_ids[i] = id;
    }
    return status;
}

// Inverse of composer_decode_event_ids. value -1 encodes None.
int composer_encode_event_pairs(
    const int32_t* ids,
    size_t count,
    int32_t velocity_bins,
    int32_t max_time_steps,
    int16_t* out_pairs) {
    const int32_t velocity_offset = 256;
    const int32_t time_shift_offset = 256 + velocity_bins;
    const int32_t sustain_on_id = time_shift_offset + max_time_steps;
    int status = 0;
    for (size_t i = 0; i < count; ++i) {
        const int32_t id = ids[i];
        int16_t type;
        int16_t value;
        if (id < 0) { type = 0; value = 0; status = 1; }
        else if (id < 128) { type = 1; value = static_cast<int16_t>(id); }
        else if (id < 256) { type = 2; value = static_cast<int16_t>(id - 128); }
        else if (id < time_shift_offset) { type = 4; value = static_cast<int16_t>(id - velocity_offset); }
        else if (id < sustain_on_id) { type = 3; value = static_cast<int16_t>(id - time_shift_offset + 1); }
        else if (id == sustain_on_id) { type = 5; value = -1; }
        else if (id == sustain_on_id + 1) { type = 6; value = -1; }
        else { type = 0; value = 0; status = 1; }
        out_pairs[2 * i] = type;
        out_pairs[2 * i + 1] = value;
    }
    return status;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Standard-MIDI-File parser (the preprocessing host hot path).
//
// Mirrors composer_tpu/midi/midi_io.py::parse_midi exactly — same tempo-map
// arithmetic (operation order preserved so doubles match bit-for-bit), same
// running-status / note-pairing / instrument-creation semantics — so the
// Python and native paths are interchangeable (differential-tested). The
// reference delegated this to pretty_midi (sequence.py:594-680), a pure
// Python event loop; at ~1k notes per file this dominates preprocess time.
//
// Handle protocol: composer_midi_parse returns an opaque handle (or NULL on
// malformed input — callers fall back to the Python parser for the proper
// exception), composer_midi_fill copies the flattened arrays out, and
// composer_midi_release frees the handle.

#include <algorithm>
#include <cmath>
#include <cstring>
#include <map>
#include <utility>
#include <vector>

namespace {

constexpr int32_t kDefaultTempo = 500000;  // us per quarter (120 bpm)

struct TrackMessage {
    int64_t tick;
    uint8_t status;
    uint8_t data1;
    uint8_t data2;
};

struct ParsedNote {
    double start;
    double end;
    int32_t pitch;
    int32_t velocity;
};

struct ParsedControl {
    double time;
    int32_t number;
    int32_t value;
};

struct ParsedInstrument {
    int32_t program = 0;
    int32_t is_drum = 0;
    std::vector<ParsedNote> notes;
    std::vector<ParsedControl> controls;
};

struct ParsedMidi {
    std::vector<ParsedInstrument> instruments;
};

// Piecewise tick->seconds map; mirrors midi_io.py::_TempoMap (same fp order).
struct TempoMap {
    std::vector<int64_t> ticks;
    std::vector<double> seconds;
    std::vector<double> rates;

    TempoMap(std::vector<std::pair<int64_t, int32_t>> changes, int32_t tpq) {
        std::sort(changes.begin(), changes.end());
        if (changes.empty() || changes.front().first != 0) {
            changes.insert(changes.begin(), {0, kDefaultTempo});
        }
        double elapsed = 0.0;
        int64_t prev_tick = 0;
        double prev_rate =
            static_cast<double>(changes.front().second) / (1000000.0 * tpq);
        ticks.push_back(0);
        seconds.push_back(0.0);
        rates.push_back(prev_rate);
        for (size_t i = 1; i < changes.size(); ++i) {
            elapsed += static_cast<double>(changes[i].first - prev_tick) * prev_rate;
            prev_tick = changes[i].first;
            prev_rate = static_cast<double>(changes[i].second) / (1000000.0 * tpq);
            ticks.push_back(changes[i].first);
            seconds.push_back(elapsed);
            rates.push_back(prev_rate);
        }
    }

    double ToSeconds(int64_t tick) const {
        // bisect_right(ticks, tick) - 1
        size_t index =
            std::upper_bound(ticks.begin(), ticks.end(), tick) - ticks.begin() - 1;
        return seconds[index] + static_cast<double>(tick - ticks[index]) * rates[index];
    }
};

bool ReadVarlen(const uint8_t* data, size_t size, size_t& offset, int64_t& value) {
    value = 0;
    for (int i = 0; i < 9; ++i) {  // SMF varints are <= 4 bytes; be lenient
        if (offset >= size) return false;
        uint8_t byte = data[offset++];
        value = (value << 7) | (byte & 0x7F);
        if (!(byte & 0x80)) return true;
    }
    return false;
}

// Parses one MTrk body into channel messages + tempo changes.
// Returns false on malformed data (caller falls back to Python).
bool ParseTrack(const uint8_t* data, size_t size,
                std::vector<TrackMessage>& messages,
                std::vector<std::pair<int64_t, int32_t>>& tempo_changes) {
    size_t offset = 0;
    int64_t tick = 0;
    int running_status = -1;
    while (offset < size) {
        int64_t delta;
        if (!ReadVarlen(data, size, offset, delta)) return false;
        tick += delta;
        if (offset >= size) return false;
        uint8_t status = data[offset];
        if (status & 0x80) {
            ++offset;
            if (status < 0xF0) running_status = status;
        } else {
            if (running_status < 0) return false;  // dangling data byte
            status = static_cast<uint8_t>(running_status);
        }

        if (status == 0xFF) {  // meta event
            if (offset >= size) return false;
            uint8_t meta_type = data[offset++];
            int64_t length;
            if (!ReadVarlen(data, size, offset, length)) return false;
            if (offset + static_cast<size_t>(length) > size) return false;
            if (meta_type == 0x51 && length >= 3) {
                int32_t tempo = (static_cast<int32_t>(data[offset]) << 16) |
                                (static_cast<int32_t>(data[offset + 1]) << 8) |
                                static_cast<int32_t>(data[offset + 2]);
                tempo_changes.emplace_back(tick, tempo);
            }
            offset += static_cast<size_t>(length);
            if (meta_type == 0x2F) return true;  // end of track
        } else if (status == 0xF0 || status == 0xF7) {  // sysex: skip
            int64_t length;
            if (!ReadVarlen(data, size, offset, length)) return false;
            if (offset + static_cast<size_t>(length) > size) return false;
            offset += static_cast<size_t>(length);
        } else {
            uint8_t kind = status & 0xF0;
            TrackMessage message{tick, status, 0, 0};
            if (kind == 0x80 || kind == 0x90 || kind == 0xA0 || kind == 0xB0 ||
                kind == 0xE0) {
                if (offset + 2 > size) return false;
                message.data1 = data[offset];
                message.data2 = data[offset + 1];
                offset += 2;
            } else if (kind == 0xC0 || kind == 0xD0) {
                if (offset + 1 > size) return false;
                message.data1 = data[offset];
                offset += 1;
            } else {
                return false;  // unknown status byte
            }
            messages.push_back(message);
        }
    }
    return true;
}

}  // namespace

extern "C" {

// Parses an SMF buffer. Returns an opaque handle (NULL on malformed input)
// and writes the flattened array sizes for composer_midi_fill.
void* composer_midi_parse(const uint8_t* data, size_t size,
                          int64_t* n_instruments, int64_t* n_notes,
                          int64_t* n_controls) {
    if (size < 14 || std::memcmp(data, "MThd", 4) != 0) return nullptr;
    uint32_t header_length = (static_cast<uint32_t>(data[4]) << 24) |
                             (static_cast<uint32_t>(data[5]) << 16) |
                             (static_cast<uint32_t>(data[6]) << 8) |
                             static_cast<uint32_t>(data[7]);
    uint16_t num_tracks = (static_cast<uint16_t>(data[10]) << 8) | data[11];
    uint16_t division = (static_cast<uint16_t>(data[12]) << 8) | data[13];

    bool smpte = (division & 0x8000) != 0;
    double smpte_rate = 0.0;
    int32_t ticks_per_quarter = division;
    if (smpte) {
        int frames = 256 - (division >> 8);  // two's complement of negative byte
        int ticks_per_frame = division & 0xFF;
        if (frames * ticks_per_frame == 0) return nullptr;
        smpte_rate = 1.0 / (frames * ticks_per_frame);
    }

    // Slice out MTrk chunks and parse them.
    std::vector<std::vector<TrackMessage>> tracks;
    std::vector<std::pair<int64_t, int32_t>> tempo_changes;
    size_t offset = 8 + header_length;
    while (offset + 8 <= size && tracks.size() < num_tracks) {
        uint32_t chunk_length = (static_cast<uint32_t>(data[offset + 4]) << 24) |
                                (static_cast<uint32_t>(data[offset + 5]) << 16) |
                                (static_cast<uint32_t>(data[offset + 6]) << 8) |
                                static_cast<uint32_t>(data[offset + 7]);
        bool is_track = std::memcmp(data + offset, "MTrk", 4) == 0;
        size_t body_start = offset + 8;
        size_t body_length = chunk_length;
        if (body_start + body_length > size) body_length = size - body_start;
        if (is_track) {
            tracks.emplace_back();
            if (!ParseTrack(data + body_start, body_length, tracks.back(),
                            tempo_changes)) {
                return nullptr;
            }
        }
        offset = body_start + chunk_length;
    }

    TempoMap tempo_map(std::move(tempo_changes),
                       smpte ? 1 : (ticks_per_quarter ? ticks_per_quarter : 1));
    auto to_seconds = [&](int64_t tick) {
        return smpte ? tick * smpte_rate : tempo_map.ToSeconds(tick);
    };

    auto result = new ParsedMidi();
    for (const auto& track : tracks) {
        // One instrument per (channel, program) used in this track, in
        // creation order (note-on or control-change, not program change).
        std::map<std::pair<int, int>, size_t> instrument_index;
        std::vector<size_t> creation_order;
        int channel_programs[16] = {0};
        // Open-note stacks keyed by (channel, pitch): (start tick, velocity,
        // instrument slot).
        std::map<std::pair<int, int>, std::vector<std::pair<int64_t, std::pair<int, size_t>>>>
            open_notes;

        size_t base = result->instruments.size();
        auto instrument_for = [&](int channel) -> size_t {
            std::pair<int, int> key{channel, channel_programs[channel]};
            auto it = instrument_index.find(key);
            if (it != instrument_index.end()) return it->second;
            size_t slot = result->instruments.size();
            result->instruments.emplace_back();
            result->instruments.back().program = channel_programs[channel];
            result->instruments.back().is_drum = (channel == 9) ? 1 : 0;
            instrument_index.emplace(key, slot);
            creation_order.push_back(slot);
            return slot;
        };

        for (const auto& message : track) {
            uint8_t kind = message.status & 0xF0;
            int channel = message.status & 0x0F;
            if (kind == 0xC0) {
                channel_programs[channel] = message.data1;
            } else if (kind == 0x90 && message.data2 > 0) {
                size_t slot = instrument_for(channel);
                open_notes[{channel, message.data1}].push_back(
                    {message.tick, {message.data2, slot}});
            } else if (kind == 0x80 || (kind == 0x90 && message.data2 == 0)) {
                auto it = open_notes.find({channel, message.data1});
                if (it != open_notes.end() && !it->second.empty()) {
                    int64_t end_tick = message.tick;
                    std::vector<std::pair<int64_t, std::pair<int, size_t>>> remaining;
                    for (const auto& open : it->second) {
                        if (open.first == end_tick) {  // zero-length: stays open
                            remaining.push_back(open);
                            continue;
                        }
                        ParsedNote note;
                        note.start = to_seconds(open.first);
                        note.end = to_seconds(end_tick);
                        note.pitch = message.data1;
                        note.velocity = open.second.first;
                        result->instruments[open.second.second].notes.push_back(note);
                    }
                    if (remaining.empty()) {
                        open_notes.erase(it);
                    } else {
                        it->second = std::move(remaining);
                    }
                }
            } else if (kind == 0xB0) {
                size_t slot = instrument_for(channel);
                result->instruments[slot].controls.push_back(
                    {to_seconds(message.tick), message.data1, message.data2});
            }
        }
        (void)base;

        // Stable (start, pitch) note order within each instrument.
        for (size_t slot : creation_order) {
            auto& notes = result->instruments[slot].notes;
            std::stable_sort(notes.begin(), notes.end(),
                             [](const ParsedNote& a, const ParsedNote& b) {
                                 if (a.start != b.start) return a.start < b.start;
                                 return a.pitch < b.pitch;
                             });
        }
    }

    // Drop instruments with neither notes nor control changes (preserving
    // the creation order of the survivors).
    std::vector<ParsedInstrument> kept;
    kept.reserve(result->instruments.size());
    for (auto& instrument : result->instruments) {
        if (!instrument.notes.empty() || !instrument.controls.empty()) {
            kept.push_back(std::move(instrument));
        }
    }
    result->instruments = std::move(kept);

    int64_t notes = 0;
    int64_t controls = 0;
    for (const auto& instrument : result->instruments) {
        notes += static_cast<int64_t>(instrument.notes.size());
        controls += static_cast<int64_t>(instrument.controls.size());
    }
    *n_instruments = static_cast<int64_t>(result->instruments.size());
    *n_notes = notes;
    *n_controls = controls;
    return result;
}

// Copies the parse result into caller-allocated arrays. Notes and controls
// are grouped by instrument (inst_note_counts / inst_control_counts give the
// group sizes, in instrument order).
int composer_midi_fill(void* handle,
                       int32_t* inst_program, int32_t* inst_is_drum,
                       int64_t* inst_note_counts, int64_t* inst_control_counts,
                       double* note_start, double* note_end,
                       int32_t* note_pitch, int32_t* note_velocity,
                       double* control_time, int32_t* control_number,
                       int32_t* control_value) {
    if (handle == nullptr) return 1;
    const auto* midi = static_cast<const ParsedMidi*>(handle);
    size_t note_cursor = 0;
    size_t control_cursor = 0;
    for (size_t i = 0; i < midi->instruments.size(); ++i) {
        const auto& instrument = midi->instruments[i];
        inst_program[i] = instrument.program;
        inst_is_drum[i] = instrument.is_drum;
        inst_note_counts[i] = static_cast<int64_t>(instrument.notes.size());
        inst_control_counts[i] = static_cast<int64_t>(instrument.controls.size());
        for (const auto& note : instrument.notes) {
            note_start[note_cursor] = note.start;
            note_end[note_cursor] = note.end;
            note_pitch[note_cursor] = note.pitch;
            note_velocity[note_cursor] = note.velocity;
            ++note_cursor;
        }
        for (const auto& control : instrument.controls) {
            control_time[control_cursor] = control.time;
            control_number[control_cursor] = control.number;
            control_value[control_cursor] = control.value;
            ++control_cursor;
        }
    }
    return 0;
}

void composer_midi_release(void* handle) {
    delete static_cast<ParsedMidi*>(handle);
}

}  // extern "C"
